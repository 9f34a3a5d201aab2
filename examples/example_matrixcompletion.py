"""Trace-minimization matrix completion
(reference example/example_matrixcompletion.m; timings in data/results.txt)."""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.abspath(
    _os.path.join(_os.path.dirname(__file__), "..")))

import sys
import time

import numpy as np

from manisdp import solve_sdp
from manisdp.frontends.workloads import matrix_completion


def main():
    p = int(sys.argv[1]) if len(sys.argv) > 1 else 2000
    data, M = matrix_completion(p, p, rank=10, m_samples=400 * 2 * p,
                                seed=3)
    t0 = time.time()
    res = solve_sdp(data.At, data.b, data.c, data.K.s,
                    theta=1e-2, tr_maxinner=6, tr_maxiter=8,
                    delta=10, alpha=0.1)
    t = time.time() - t0
    Z = res.X[:p, p:]
    err = np.abs(Z - M).max()
    print(f"ManiSDP-JAX: optimum = {res.obj:0.8f}, eta = {res.eta:0.1e}, "
          f"recovery = {err:0.1e}, time = {t:0.2f}s")


if __name__ == "__main__":
    main()
