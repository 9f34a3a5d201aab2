"""Batched-instance MaxCut: solve a fleet of unit-diagonal SDPs
concurrently (new capability; the reference is one instance
per MATLAB process).  Random graph family, one vmapped solve."""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.abspath(
    _os.path.join(_os.path.dirname(__file__), "..")))

import sys
import time

import numpy as np

from manisdp import solve_maxcut_batch


def random_graph_cost(n, density, seed):
    """MaxCut cost C = -L/4 of a random weighted graph."""
    rs = np.random.RandomState(seed)
    A = (rs.rand(n, n) < density) * rs.rand(n, n)
    A = np.triu(A, 1)
    A = A + A.T
    L = np.diag(A.sum(axis=1)) - A
    return -L / 4.0


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 100
    B = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    Cs = [random_graph_cost(n, 0.1, seed) for seed in range(B)]
    t0 = time.time()
    results = solve_maxcut_batch(Cs, tol=1e-8, verbose=True)
    dt = time.time() - t0
    for b, r in enumerate(results):
        print(f"  instance {b}: obj = {r.obj:.6f}, dinf = {r.dinf:.1e}, "
              f"status = {r.status}")
    print(f"batch of {B} solved in {dt:.2f}s "
          f"({dt / B:.2f}s amortized per instance)")


if __name__ == "__main__":
    main()
