"""Dual multiblock driver: block-diagonal composition cross-checks."""

import numpy as np
import scipy.sparse as sp

from manisdp.frontends.moments import monomial_basis
from manisdp.frontends.sos import assemble_bqpsos, qssos
from manisdp.solvers.dual_general import solve_dual_sdp
from manisdp.solvers.dual_multiblock import solve_dual_multiblock
from manisdp.solvers.dual_unitdiag import solve_dual_unitdiag


def bqp_instance(n, seed):
    rs = np.random.RandomState(seed)
    Q = rs.randn(n, n)
    Q = 0.5 * (Q + Q.T)
    e = rs.randn(n)
    return assemble_bqpsos(Q, e, n)


def test_single_block_matches_dual_unitdiag():
    A, b, c, mb, f, dAAt = bqp_instance(6, 0)
    maxb = np.max(np.abs(b))
    r1 = solve_dual_unitdiag(A, b / maxb, c, mb, f=f, dAAt=dAAt,
                             line_search=True, verbose=False)
    r2 = solve_dual_multiblock(A, b / maxb, c, ns=[mb], nob=1, f=f,
                               dAAt=dAAt, verbose=False,
                               sigma0=1e-3, sigma_min=1e-3,
                               tau1=1e1, tau2=1e2, theta=1e-3, alpha=0.1)
    assert r2.status == 0
    np.testing.assert_allclose(r2.obj, r1.obj, rtol=1e-6)


def test_two_oblique_blocks_sum():
    """Two independent SOS-BQP blocks in one multiblock dual solve."""
    A1, b1, c1, mb1, f1, d1 = bqp_instance(5, 1)
    A2, b2, c2, mb2, f2, d2 = bqp_instance(4, 2)
    scale = max(np.max(np.abs(b1)), np.max(np.abs(b2)))

    r1 = solve_dual_unitdiag(A1, b1 / scale, c1, mb1, f=f1, dAAt=d1,
                             line_search=True, verbose=False)
    r2 = solve_dual_unitdiag(A2, b2 / scale, c2, mb2, f=f2, dAAt=d2,
                             line_search=True, verbose=False)

    # columns: [free1, free2, psd1, psd2]; rows: constraints stacked
    m1, m2 = A1.shape[0], A2.shape[0]
    free1 = A1[:, :1]
    psd1 = A1[:, 1:]
    free2 = A2[:, :1]
    psd2 = A2[:, 1:]
    A = sp.bmat([[free1, None, psd1, None],
                 [None, free2, None, psd2]]).tocsr()
    b = np.concatenate([b1, b2]) / scale
    c = np.concatenate([[1.0, 1.0], np.zeros(mb1 ** 2 + mb2 ** 2)])
    dAAt = np.concatenate([d1, d2])

    res = solve_dual_multiblock(A, b, c, ns=[mb1, mb2], nob=2, f=2,
                                dAAt=dAAt, verbose=False,
                                sigma0=1e-3, sigma_min=1e-3,
                                tau1=1e1, tau2=1e2, theta=1e-3, alpha=0.1)
    assert res.status == 0
    np.testing.assert_allclose(res.obj, r1.obj + r2.obj, rtol=1e-6)


def test_mixed_blocks_with_composite_update():
    """Unit-diagonal SOS-BQP block + Euclidean quartic-sphere SOS block
    (nob < nb exercises the composite iAB x-update)."""
    A1, b1, c1, mb1, f1, d1 = bqp_instance(4, 3)
    nq = 3
    rs = np.random.RandomState(4)
    coe = rs.randn(monomial_basis(nq, 4).shape[1])
    A2, b2, c2, mb2, f2, d2 = qssos(nq, coe)
    scale = max(np.max(np.abs(b1)), np.max(np.abs(b2)))

    r1 = solve_dual_unitdiag(A1, b1 / scale, c1, mb1, f=f1, dAAt=d1,
                             line_search=True, verbose=False)
    r2 = solve_dual_sdp(A2, b2 / scale, c2, mb2, f=f2, dAAt=d2,
                        verbose=False, theta=1e-1, tau2=0.5)

    free1 = A1[:, :f1]
    psd1 = A1[:, f1:]
    free2 = A2[:, :f2]
    psd2 = A2[:, f2:]
    A = sp.bmat([[free1, None, psd1, None],
                 [None, free2, None, psd2]]).tocsr()
    b = np.concatenate([b1, b2]) / scale
    c = np.concatenate([c1[:f1], c2[:f2],
                        np.zeros(mb1 ** 2 + mb2 ** 2)])
    dAAt = np.concatenate([d1, d2])

    res = solve_dual_multiblock(A, b, c, ns=[mb1, mb2], nob=1, f=f1 + f2,
                                dAAt=dAAt, verbose=False, max_outer=1000)
    assert res.status == 0
    np.testing.assert_allclose(res.obj, r1.obj + r2.obj,
                               rtol=1e-5, atol=1e-6)
