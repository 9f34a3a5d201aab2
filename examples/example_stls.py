"""Structured total least squares: nearest rank-deficient Hankel matrix
(reference example/example_stls.m; n1 = n2 = 20, "stls" recipe).

Builds the kron-lifted Shor relaxation (frontends/stls.py), solves with
the general driver, and verifies rank-one tightness by extraction."""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.abspath(
    _os.path.join(_os.path.dirname(__file__), "..")))

import sys
import time

import numpy as np

from manisdp import solve_sdp
from manisdp.frontends.stls import (extract_solution,
                                    nearest_hankel_sdp, stls_objective)
from manisdp.recipes import recipe


def main():
    n1 = n2 = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    k = n1 + n2 - 1
    rs = np.random.RandomState(1)
    u1 = rs.randn(k)

    data = nearest_hankel_sdp(u1, n1, n2)
    _, kw = recipe("stls")
    t0 = time.time()
    res = solve_sdp(data.At, data.b, data.c, data.K.s, max_outer=500, **kw)
    t = time.time() - t0
    val = stls_objective(res.obj, u1)
    u, z, resid = extract_solution(res.X, n1, n2)
    print(f"ManiSDP-JAX: optimum = {val:0.8f}, eta = {res.eta:0.1e}, "
          f"kernel resid = {resid:0.1e}, time = {t:0.2f}s")


if __name__ == "__main__":
    main()
