"""Moment-relaxation generators: exactness on feasible moment vectors.

For any real point x, the rank-1 moment matrix X = m(x) m(x)' (m = the
monomial basis evaluated at x) must satisfy A(X) = b exactly and
<C, X> = objective(x).  This checks every generated constraint and the
cost against ground truth without involving the solver.
"""

import numpy as np

from manisdp.frontends.moments import bqpmom, qsmom
from manisdp.frontends.monomials import basis_index, monomial_basis


def eval_basis(basis, x):
    return np.prod(x[:, None] ** basis, axis=0)


def test_bqpmom_feasible_moment_vectors():
    n = 5
    rs = np.random.RandomState(0)
    Q = rs.randn(n, n)
    Q = 0.5 * (Q + Q.T)
    e = rs.randn(n)
    data = bqpmom(n, Q, e)
    mb = data.K.s
    basis = monomial_basis(n, 2, max_power=1)
    assert basis.shape[1] == mb

    for trial in range(5):
        x = rs.choice([-1.0, 1.0], size=n)
        m = eval_basis(basis, x)
        X = np.outer(m, m)
        lhs = data.At.T @ X.flatten(order="F")
        np.testing.assert_allclose(lhs, data.b, atol=1e-12)
        obj = float(data.c @ X.flatten(order="F"))
        np.testing.assert_allclose(obj, x @ Q @ x + e @ x, atol=1e-10)
        np.testing.assert_allclose(np.diag(X), 1.0)


def test_qsmom_feasible_moment_vectors():
    n = 4
    rs = np.random.RandomState(1)
    coe = rs.randn(monomial_basis(n, 4).shape[1])
    data = qsmom(n, coe)
    mb = data.K.s
    basis2 = monomial_basis(n, 2)
    basis4 = monomial_basis(n, 4)
    assert basis2.shape[1] == mb

    for trial in range(5):
        x = rs.randn(n)
        x = x / np.linalg.norm(x)
        m = eval_basis(basis2, x)
        X = np.outer(m, m)
        lhs = data.At.T @ X.flatten(order="F")
        np.testing.assert_allclose(lhs, data.b, atol=1e-12)
        obj = float(data.c @ X.flatten(order="F"))
        np.testing.assert_allclose(obj, coe @ eval_basis(basis4, x),
                                   atol=1e-10)


def test_bqp_end_to_end_tight():
    """Small BQP: the order-2 moment bound matches the brute-force
    optimum (relaxation is tight on this instance), solved by the
    unit-diagonal driver."""
    from manisdp import solve_unitdiag

    n = 6
    rs = np.random.RandomState(3)
    Q = rs.randn(n, n)
    Q = 0.5 * (Q + Q.T)
    e = rs.randn(n)
    data = bqpmom(n, Q, e)

    # brute force over {-1,1}^n
    best = np.inf
    for bits in range(2 ** n):
        x = np.array([1.0 if (bits >> i) & 1 else -1.0 for i in range(n)])
        best = min(best, x @ Q @ x + e @ x)

    res = solve_unitdiag(data.At, data.b, data.c, data.K.s, verbose=False)
    assert res.status == 0
    assert res.eta < 1e-8
    np.testing.assert_allclose(res.obj, best, rtol=1e-6)


def test_qs_end_to_end():
    """Small quartic-sphere instance through the general driver
    (example_qsphere.m:27 uses ManiSDP with theta=1e-2, tau1=0.02),
    verified against the moment bound <= sampled minimum."""
    from manisdp import solve_sdp

    n = 3
    rs = np.random.RandomState(5)
    basis4 = monomial_basis(n, 4)
    coe = rs.randn(basis4.shape[1])
    data = qsmom(n, coe)

    res = solve_sdp(data.At, data.b, data.c, data.K.s, verbose=False,
                    theta=1e-2, tau1=0.02)
    assert res.status == 0
    assert res.eta < 1e-8
    # dense sampling upper-bounds the true minimum; bound must hold
    xs = rs.randn(20000, n)
    xs /= np.linalg.norm(xs, axis=1, keepdims=True)
    vals = np.array([coe @ eval_basis(basis4, x) for x in xs])
    assert res.obj <= vals.min() + 1e-6
