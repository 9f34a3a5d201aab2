"""Multiblock driver: block-diagonal composition of known problems.

With no cross-block constraints the multiblock optimum equals the sum
of single-block optima, giving an exact cross-check against the
single-block drivers."""

import numpy as np
import scipy.sparse as sp

from manisdp import solve_maxcut_unitdiag, solve_unitdiag
from manisdp.frontends.moments import bqpmom
from manisdp.solvers.multiblock import solve_multiblock


def diag_constraints(n):
    rows = np.arange(n) * n + np.arange(n)
    At = sp.coo_matrix((np.ones(n), (rows, np.arange(n))),
                       shape=(n * n, n)).tocsc()
    return At, np.ones(n)


def random_cost(n, seed):
    rs = np.random.RandomState(seed)
    B = rs.randn(n, n)
    C = 0.5 * (B + B.T)
    np.fill_diagonal(C, 0.0)
    return C


def test_two_oblique_blocks():
    """Two independent BQP moment blocks, both unit-diagonal (nob=2)."""
    n1, n2 = 5, 4
    rs = np.random.RandomState(0)
    Q1 = rs.randn(n1, n1); Q1 = 0.5 * (Q1 + Q1.T)
    e1 = rs.randn(n1)
    Q2 = rs.randn(n2, n2); Q2 = 0.5 * (Q2 + Q2.T)
    e2 = rs.randn(n2)
    d1 = bqpmom(n1, Q1, e1)
    d2 = bqpmom(n2, Q2, e2)
    mb1, mb2 = d1.K.s, d2.K.s

    r1 = solve_unitdiag(d1.At, d1.b, d1.c, mb1, verbose=False)
    r2 = solve_unitdiag(d2.At, d2.b, d2.c, mb2, verbose=False)

    At = sp.block_diag([d1.At, d2.At]).tocsc()
    b = np.concatenate([d1.b, d2.b])
    c = np.concatenate([d1.c, d2.c])
    res = solve_multiblock(At, b, c, ns=[mb1, mb2], nob=2, verbose=False,
                           sigma0=1e-3, sigma_min=1e-2, tau1=1, tau2=1)
    assert res.status == 0
    assert res.eta < 1e-8
    np.testing.assert_allclose(res.obj, r1.obj + r2.obj, rtol=1e-6)


def test_mixed_oblique_euclidean_blocks():
    """Block 1 unit-diagonal (manifold), block 2 Euclidean with diag
    pinned through explicit constraints — optimum = sum of the
    single-block MaxCut-style optima."""
    n1, n2 = 12, 10
    C1 = random_cost(n1, 1)
    C2 = random_cost(n2, 2)
    r1 = solve_maxcut_unitdiag(C1, verbose=False)
    r2 = solve_maxcut_unitdiag(C2, verbose=False)

    At2, b2 = diag_constraints(n2)
    At = sp.block_diag([sp.csc_matrix((n1 * n1, 0)), At2]).tocsc()
    b = b2
    c = np.concatenate([C1.flatten(order="F"), C2.flatten(order="F")])
    res = solve_multiblock(At, b, c, ns=[n1, n2], nob=1, verbose=False,
                           max_outer=500)
    assert res.status == 0
    assert res.eta < 1e-8
    np.testing.assert_allclose(res.obj, r1.obj + r2.obj, rtol=1e-6)
    np.testing.assert_allclose(np.diag(res.X[0]), 1.0, atol=1e-10)
    np.testing.assert_allclose(np.diag(res.X[1]), 1.0, atol=1e-7)
