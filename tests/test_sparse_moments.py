"""Clique-sparse moment generator: feasible-moment exactness +
end-to-end multiblock solve vs brute force."""

import numpy as np

from manisdp.frontends.sparse_moments import (bqpmom_sparse, clique_chain,
                                              sparse_objective_basis)
from manisdp.frontends.monomials import monomial_basis
from manisdp.solvers.multiblock import solve_multiblock


def eval_basis(basis, x):
    return np.prod(x[:, None] ** basis, axis=0)


def _instance(t, q, seed):
    n, cliques = clique_chain(t, q)
    nsp = sparse_objective_basis(n, cliques)
    nsp = nsp[:, ~np.all(nsp == 0, axis=0)]
    rs = np.random.RandomState(seed)
    coe = rs.randn(nsp.shape[1])
    return n, cliques, nsp, coe


def test_feasible_moment_vectors():
    n, cliques, nsp, coe = _instance(3, 4, 0)
    data = bqpmom_sparse(n, cliques, coe)
    mbs = data.K.s
    rs = np.random.RandomState(1)
    for _ in range(4):
        x = rs.choice([-1.0, 1.0], size=n)
        xs = []
        for I, mb in zip(cliques, mbs):
            sub = monomial_basis(len(I), 2, max_power=1)
            m = eval_basis(sub, x[np.asarray(I)])
            assert len(m) == mb
            xs.append(np.outer(m, m).flatten(order="F"))
        xstack = np.concatenate(xs)
        np.testing.assert_allclose(data.At.T @ xstack, data.b, atol=1e-12)
        obj = float(data.c @ xstack)
        np.testing.assert_allclose(obj, coe @ eval_basis(nsp, x), atol=1e-10)


def test_sparse_bqp_dual_agreement():
    """bqpsos_sparse dual route == bqpmom_sparse primal route
    (the reference's own self-consistency check,
    example_bqp_sparse.m:30-60)."""
    from manisdp.frontends.sparse_moments import bqpsos_sparse
    from manisdp.solvers.dual_multiblock import solve_dual_multiblock

    n, cliques, nsp, coe = _instance(3, 5, 3)
    data = bqpmom_sparse(n, cliques, coe)
    rp = solve_multiblock(data.At, data.b, data.c, ns=data.K.s,
                          nob=data.K.nob, verbose=False,
                          line_search=True, tau1=1.0, max_outer=500)
    assert rp.status == 0

    A, b, c, mbs, f, dAAt = bqpsos_sparse(n, cliques, coe)
    maxb = np.max(np.abs(b))
    rd = solve_dual_multiblock(A, b / maxb, c, ns=mbs, nob=len(mbs), f=f,
                               dAAt=dAAt, verbose=False)
    assert rd.status == 0
    np.testing.assert_allclose(rd.obj * maxb, rp.obj, rtol=1e-7)


def test_sparse_bqp_end_to_end():
    n, cliques, nsp, coe = _instance(2, 4, 2)
    data = bqpmom_sparse(n, cliques, coe)

    best = np.inf
    for bits in range(2 ** n):
        x = np.array([1.0 if (bits >> i) & 1 else -1.0 for i in range(n)])
        best = min(best, coe @ eval_basis(nsp, x))

    res = solve_multiblock(data.At, data.b, data.c, ns=data.K.s,
                           nob=data.K.nob, verbose=False,
                           line_search=True, tau1=1.0, max_outer=500)
    assert res.status == 0
    assert res.eta < 1e-8
    assert res.obj <= best + 1e-7
    np.testing.assert_allclose(res.obj, best, rtol=1e-6)
