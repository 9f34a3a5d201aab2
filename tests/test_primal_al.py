"""End-to-end tests for the primal AL drivers (unitdiag / unittrace /
general), verified by the external KKT oracle and cross-driver
agreement."""

import numpy as np
import scipy.sparse as sp

from manisdp import (solve_maxcut_unitdiag, solve_sdp, solve_unitdiag,
                     solve_unittrace)

RNG = np.random.RandomState(7)


def diag_constraints(n):
    """A(X) = diag(X) = 1 in SeDuMi layout (At is n^2 x n)."""
    rows = np.arange(n) * n + np.arange(n)
    At = sp.coo_matrix((np.ones(n), (rows, np.arange(n))),
                       shape=(n * n, n)).tocsc()
    return At, np.ones(n)


def random_sym_cost(n, seed=0):
    rs = np.random.RandomState(seed)
    B = rs.randn(n, n)
    C = 0.5 * (B + B.T)
    np.fill_diagonal(C, 0.0)
    return C


def kkt_oracle(C, At, b, res):
    """eta computed from raw (X, y, S) outside the solver
    (example_maxcut.m:44-49 style)."""
    X, y = res.X, res.y
    A = At.T
    x = X.flatten(order="F")
    pinf = np.linalg.norm(A @ x - b) / (1 + np.linalg.norm(b))
    obj = float(np.sum(C * X))
    S = res.S
    w = np.linalg.eigvalsh(S)
    dinf = max(0.0, -w[0]) / (1 + w[-1])
    return max(pinf, dinf), obj


def test_general_matches_maxcut_driver():
    """diag(X)=1 via explicit A on the general driver == oblique driver."""
    n = 25
    C = random_sym_cost(n, seed=1)
    At, b = diag_constraints(n)
    c = C.flatten(order="F")

    res_g = solve_sdp(At, b, c, n, verbose=False, max_outer=300)
    res_m = solve_maxcut_unitdiag(C, verbose=False)

    assert res_g.status == 0
    eta, obj = kkt_oracle(C, At, b, res_g)
    assert eta < 1e-7
    np.testing.assert_allclose(res_g.obj, res_m.obj, rtol=1e-6)


def test_unitdiag_with_extra_constraint():
    """Unit-diag SDP with one extra affine constraint, oracle-checked."""
    n = 20
    C = random_sym_cost(n, seed=2)
    At_d, b_d = diag_constraints(n)
    # extra symmetric constraint: X[0,1] + X[1,0] = 2*t with a feasible t
    res0 = solve_maxcut_unitdiag(C, verbose=False)
    t = 0.5 * res0.X[0, 1]          # halfway toward 0: perturbs optimum
    extra = sp.coo_matrix(([1.0, 1.0], ([0 + 1 * n, 1 + 0 * n], [0, 0])),
                          shape=(n * n, 1)).tocsc()
    At = sp.hstack([extra]).tocsc()
    b = np.array([2 * t])
    c = C.flatten(order="F")

    res = solve_unitdiag(At, b, c, n, verbose=False, sigma0=1e-1)
    assert res.status == 0
    # oracle: feasibility of the extra constraint + dual feasibility
    assert abs(res.X[0, 1] - t) < 1e-6
    np.testing.assert_allclose(np.diag(res.X), 1.0, atol=1e-10)
    w = np.linalg.eigvalsh(res.S)
    assert max(0.0, -w[0]) / (1 + w[-1]) < 1e-7
    # the constrained optimum must be >= unconstrained
    assert res.obj >= res0.obj - 1e-6


def test_unittrace_rayleigh():
    """min <C,X>, tr(X)=1 with a consistent extra constraint ->
    optimum = lambda_min(C)."""
    n = 15
    C = random_sym_cost(n, seed=3)
    wmin, V = np.linalg.eigh(C)
    v = V[:, 0]
    # extra constraint consistent with the rank-1 optimum: X[0,0] = v0^2
    At = sp.coo_matrix(([1.0], ([0], [0])), shape=(n * n, 1)).tocsc()
    b = np.array([v[0] ** 2])
    c = C.flatten(order="F")

    res = solve_unittrace(At, b, c, n, verbose=False,
                          sigma0=1e1, sigma_min=1e0)
    assert res.status == 0
    np.testing.assert_allclose(res.obj, wmin[0], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(np.trace(res.X), 1.0, atol=1e-8)


def test_general_warm_start():
    n = 15
    C = random_sym_cost(n, seed=4)
    At, b = diag_constraints(n)
    c = C.flatten(order="F")
    res1 = solve_sdp(At, b, c, n, verbose=False, max_outer=300)
    res2 = solve_sdp(At, b, c, n, verbose=False, max_outer=300, Y0=res1.Y)
    assert res2.status == 0
    assert res2.iterations <= res1.iterations


def test_slow_progress_detector():
    """Status-2 detector semantics (ManiSDP_unitdiag.m:82-92): every
    ``period`` iterations, flag when ALL residuals are strictly worse
    than at the previous checkpoint (after warmup); improving or flat
    residuals reset the baseline."""
    from manisdp.solvers.common import SlowProgress

    slow = SlowProgress(period=20, warmup=50)
    # mid-iteration calls never trigger
    assert not slow.check(7, 1.0, 1.0, 1.0)
    # first checkpoint records the baseline
    assert not slow.check(20, 1.0, 1.0, 1.0)
    # worsening residuals but still in warmup -> no trigger
    assert not slow.check(40, 2.0, 2.0, 2.0)
    # one improving residual resets -> no trigger
    assert not slow.check(60, 3.0, 1.0, 3.0)
    # all strictly worse after warmup -> status-2 trigger
    assert slow.check(80, 4.0, 2.0, 4.0)


def test_dense_op_matches_sparse_op():
    """The dense-carrier constraint-operator path (DenseConstraintOp) must
    reproduce the factored path's trajectory on all three variants."""
    n = 8
    rs = np.random.RandomState(9)
    Q = rs.randn(n, n)
    Q = 0.5 * (Q + Q.T)
    e = rs.randn(n)
    from manisdp.frontends.moments import bqpmom
    d = bqpmom(n, Q, e)

    r_dense = solve_unitdiag(d.At, d.b, d.c, d.K.s, verbose=False,
                             al_op_mode="dense")
    r_sparse = solve_unitdiag(d.At, d.b, d.c, d.K.s, verbose=False,
                              al_op_mode="sparse")
    assert r_dense.status == 0 and r_sparse.status == 0
    np.testing.assert_allclose(r_dense.obj, r_sparse.obj, rtol=1e-9)
    assert r_dense.iterations == r_sparse.iterations
    # the first iteration starts from identical state; later iterations
    # may diverge in fp reduction order before reconverging
    np.testing.assert_allclose(r_dense.history[0]["pinf"],
                               r_sparse.history[0]["pinf"],
                               rtol=1e-8, atol=1e-12)
