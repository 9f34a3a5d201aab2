"""Lovasz theta of a random graph (reference example/example_theta.m:
tol=1e-6, sigma0=1e5, sigma_max=1e8, line_search on)."""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.abspath(
    _os.path.join(_os.path.dirname(__file__), "..")))

import sys
import time

import numpy as np
import scipy.sparse as sp

from manisdp import solve_unittrace
from manisdp.frontends.workloads import lovasz_theta


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1000
    data = lovasz_theta(n, 10 * n, seed=1)
    At = sp.csc_matrix(data.At)
    m = At.shape[1] - 1          # trace row -> the manifold
    t0 = time.time()
    res = solve_unittrace(At[:, :m], data.b[:m], data.c, data.K.s,
                          tol=1e-6, sigma0=1e5, sigma_max=1e8,
                          line_search=True)
    print(f"ManiSDP-JAX: theta = {-res.obj:0.8f}, eta = {res.eta:0.1e}, "
          f"time = {time.time() - t0:0.2f}s")


if __name__ == "__main__":
    main()
