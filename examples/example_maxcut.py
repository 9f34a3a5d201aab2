"""MaxCut SDP on a Gset graph (reference example/example_maxcut.m).

Usage: python examples/example_maxcut.py [G1] [p0]
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.abspath(
    _os.path.join(_os.path.dirname(__file__), "..")))

import sys
import time

import numpy as np

from manisdp import solve_maxcut_unitdiag
from manisdp.frontends.gset import maxcut_cost

GSET = "/root/reference/data/Gset"


def main():
    graph = sys.argv[1] if len(sys.argv) > 1 else "G1"
    p0 = int(sys.argv[2]) if len(sys.argv) > 2 else 40
    C = maxcut_cost(f"{GSET}/{graph}.txt")
    t0 = time.time()
    res = solve_maxcut_unitdiag(C, p0=p0)
    t = time.time() - t0
    # external KKT oracle (example_maxcut.m:44-49)
    X = res.X
    Cd = np.asarray(C.todense())
    z = np.sum(Cd * X, axis=0)
    S = Cd - np.diag(z)
    w = np.linalg.eigvalsh(S) if X.shape[0] <= 4000 else None
    eta = res.dinf if w is None else max(0.0, -w[0]) / (1 + w[-1])
    print(f"ManiSDP-JAX: optimum = {res.obj:0.8f}, eta = {eta:0.1e}, "
          f"time = {t:0.2f}s")


if __name__ == "__main__":
    main()
