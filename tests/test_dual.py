"""Dual ADMM drivers: primal/dual route agreement (the reference's own
self-consistency test, example_bqp_dual.m:10-40)."""

import numpy as np

from manisdp.frontends.moments import bqpmom, qsmom
from manisdp.frontends.monomials import monomial_basis
from manisdp.frontends.sos import assemble_bqpsos, bqpsos, qssos
from manisdp.solvers.dual_general import solve_dual_sdp
from manisdp.solvers.dual_unitdiag import solve_dual_unitdiag
from manisdp.solvers.general import solve_sdp
from manisdp.solvers.unitdiag import solve_unitdiag


def test_bqp_primal_dual_agreement():
    n = 8
    rs = np.random.RandomState(1)
    Q = rs.randn(n, n)
    Q = 0.5 * (Q + Q.T)
    e = rs.randn(n)

    data = bqpmom(n, Q, e)
    res_p = solve_unitdiag(data.At, data.b, data.c, data.K.s, verbose=False)
    assert res_p.status == 0

    A, b, c, mb, f, dAAt = assemble_bqpsos(Q, e, n)
    maxb = np.max(np.abs(b))
    res_d = solve_dual_unitdiag(A, b / maxb, c, mb, f=f, dAAt=dAAt,
                                line_search=True, verbose=False)
    assert res_d.status == 0
    np.testing.assert_allclose(res_d.obj * maxb, res_p.obj, rtol=1e-7)


def test_qs_primal_dual_agreement():
    n = 4
    rs = np.random.RandomState(2)
    coe = rs.randn(monomial_basis(n, 4).shape[1])

    data = qsmom(n, coe)
    res_p = solve_sdp(data.At, data.b, data.c, data.K.s, verbose=False,
                      theta=1e-2, tau1=0.02)
    assert res_p.status == 0

    A, b, c, mb, f, dAAt = qssos(n, coe)
    maxb = np.max(np.abs(b))
    res_d = solve_dual_sdp(A, b / maxb, c, mb, f=f, dAAt=dAAt,
                           verbose=False, theta=1e-1, tau2=0.5)
    assert res_d.status == 0
    np.testing.assert_allclose(res_d.obj * maxb, res_p.obj,
                               rtol=1e-6, atol=1e-6)


def test_bqpsos_diagonal_aat():
    """The closed-form dAAt must equal diag(A_psd A_psd') and AA' must
    actually BE diagonal (the y-step invariant, ManiDSDP_unitdiag.m:39)."""
    n = 6
    rs = np.random.RandomState(3)
    Q = rs.randn(n, n)
    Q = 0.5 * (Q + Q.T)
    e = rs.randn(n)
    A, b, dAAt, mb = bqpsos(Q, e, n)
    G = (A @ A.T).toarray()
    np.testing.assert_allclose(np.diag(G), dAAt)
    np.testing.assert_allclose(G, np.diag(dAAt), atol=1e-12)


def test_qssos_diagonal_aat():
    n = 4
    rs = np.random.RandomState(4)
    coe = rs.randn(monomial_basis(n, 4).shape[1])
    A, b, c, mb, f, dAAt = qssos(n, coe)
    Apsd = A[:, f:]
    G = (Apsd @ Apsd.T).toarray()
    np.testing.assert_allclose(np.diag(G), dAAt)
    np.testing.assert_allclose(G, np.diag(dAAt), atol=1e-12)
