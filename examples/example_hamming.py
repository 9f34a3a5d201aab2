"""Lovasz theta of Hamming graphs (reference example/generate_hamming.m).

H(k, {1}) is the k-cube, which is bipartite, so theta equals the
independence number 2^(k-1) exactly — a free closed-form oracle."""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.abspath(
    _os.path.join(_os.path.dirname(__file__), "..")))

import sys
import time

import numpy as np
import scipy.sparse as sp

from manisdp import solve_unittrace
from manisdp.frontends.workloads import hamming_theta


def main():
    k = int(sys.argv[1]) if len(sys.argv) > 1 else 5
    data = hamming_theta(k, [1])
    At = sp.csc_matrix(data.At)
    m = At.shape[1] - 1           # trace row -> handled by the manifold
    t0 = time.time()
    res = solve_unittrace(At[:, :m], data.b[:m], data.c, data.K.s,
                          sigma0=1e3, sigma_max=1e8, line_search=True,
                          tol=1e-8, max_outer=300)
    t = time.time() - t0
    theta = -res.obj
    print(f"ManiSDP-JAX: theta(H({k},{{1}})) = {theta:0.8f} "
          f"(exact {2 ** (k - 1)}), eta = {res.eta:0.1e}, "
          f"time = {t:0.2f}s")


if __name__ == "__main__":
    main()
