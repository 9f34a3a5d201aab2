"""Sparse quartic-sphere generators (qsmom_sparse / qssos_sparse):
moment feasibility + primal/dual multiblock agreement."""

import numpy as np

from manisdp.frontends.monomials import monomial_basis
from manisdp.frontends.sparse_moments import (qsmom_sparse, qssos_sparse,
                                              sparse_quartic_basis)
from manisdp.solvers.dual_multiblock import solve_dual_multiblock
from manisdp.solvers.multiblock import solve_multiblock

N = 7
CLIQUES = [[0, 1, 2, 3], [3, 4, 5, 6]]


def eval_basis(basis, x):
    return np.prod(x[:, None] ** basis, axis=0)


def feasible_point(rs):
    """Each clique's variables on its own unit sphere (shared var 3)."""
    t = 0.5
    x = rs.randn(N)
    x[3] = t
    x[0:3] *= np.sqrt((1 - t * t) / (x[0:3] ** 2).sum())
    x[4:7] *= np.sqrt((1 - t * t) / (x[4:7] ** 2).sum())
    return x


def test_qsmom_sparse_moment_feasibility():
    spm = sparse_quartic_basis(N, CLIQUES)
    coe = np.random.RandomState(0).randn(spm.shape[1])
    data = qsmom_sparse(N, CLIQUES, coe)
    rs = np.random.RandomState(1)
    for _ in range(3):
        x = feasible_point(rs)
        xs = []
        for I in CLIQUES:
            sub = monomial_basis(len(I), 2)
            m = eval_basis(sub, x[np.asarray(I)])
            xs.append(np.outer(m, m).flatten(order="F"))
        xstack = np.concatenate(xs)
        np.testing.assert_allclose(data.At.T @ xstack, data.b, atol=1e-12)
        np.testing.assert_allclose(float(data.c @ xstack),
                                   coe @ eval_basis(spm, x), atol=1e-10)


def test_sparse_quartic_primal_dual_agreement():
    spm = sparse_quartic_basis(N, CLIQUES)
    coe = np.random.RandomState(0).randn(spm.shape[1])
    data = qsmom_sparse(N, CLIQUES, coe)
    rp = solve_multiblock(data.At, data.b, data.c, ns=data.K.s, nob=0,
                          verbose=False, theta=1e-2, tau1=0.02, tau2=0.1,
                          sigma0=1e-2, sigma_min=1e-1, line_search=True,
                          max_outer=1000)
    assert rp.status == 0

    A, b, c, mbs, f, dAAt = qssos_sparse(N, CLIQUES, coe)
    maxb = np.max(np.abs(b))
    rd = solve_dual_multiblock(A, b / maxb, c, ns=mbs, nob=0, f=f,
                               dAAt=dAAt, verbose=False, gama=2.0,
                               alpha=0.01, sigma0=1e-2, theta=1e-2,
                               delta=6, max_outer=1000)
    assert rd.status == 0
    np.testing.assert_allclose(rd.obj * maxb, rp.obj, rtol=1e-6, atol=1e-7)
