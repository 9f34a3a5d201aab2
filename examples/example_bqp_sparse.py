"""Clique-sparse BQP through the multiblock drivers
(reference example/example_bqp_sparse.m)."""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.abspath(
    _os.path.join(_os.path.dirname(__file__), "..")))

import sys
import time

import numpy as np

from manisdp.frontends.sparse_moments import (bqpmom_sparse,
                                              bqpsos_sparse,
                                              clique_chain,
                                              sparse_objective_basis)
from manisdp.solvers.dual_multiblock import solve_dual_multiblock
from manisdp.solvers.multiblock import solve_multiblock


def main():
    t = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    q = int(sys.argv[2]) if len(sys.argv) > 2 else 20
    n, cliques = clique_chain(t, q)
    nsp = sparse_objective_basis(n, cliques)
    nsp = nsp[:, ~np.all(nsp == 0, axis=0)]
    coe = np.random.RandomState(1).randn(nsp.shape[1])

    data = bqpmom_sparse(n, cliques, coe)
    t0 = time.time()
    rp = solve_multiblock(data.At, data.b, data.c, ns=data.K.s,
                          nob=data.K.nob, line_search=True, tau1=1.0)
    print(f"primal multiblock: optimum = {rp.obj:0.8f}, "
          f"eta = {rp.eta:0.1e}, time = {time.time() - t0:0.2f}s")

    A, b, c, mbs, f, dAAt = bqpsos_sparse(n, cliques, coe)
    maxb = np.max(np.abs(b))
    t0 = time.time()
    rd = solve_dual_multiblock(A, b / maxb, c, ns=mbs, nob=len(mbs), f=f,
                               dAAt=dAAt)
    print(f"dual multiblock:   optimum = {rd.obj * maxb:0.8f}, "
          f"eta = {rd.eta:0.1e}, time = {time.time() - t0:0.2f}s")


if __name__ == "__main__":
    main()
