"""Mixed-precision inner solve: f32 RTR pre-stage + f64 refinement.

The f32 stage only warm-starts the f64 stage; certification (dinf) is
always f64, so the solution must reach the same 1e-8 KKT quality as the
pure-f64 path.
"""

import numpy as np

from manisdp import solve_maxcut_unitdiag


def _random_laplacian_cost(n=60, seed=0):
    rs = np.random.RandomState(seed)
    W = (rs.rand(n, n) < 0.2).astype(np.float64)
    W = np.triu(W, 1)
    W = W + W.T
    L = np.diag(W.sum(axis=1)) - W
    return -L / 4.0


def test_mixed_al_driver_matches_f64():
    from manisdp import solve_unitdiag
    from manisdp.frontends.moments import bqpmom

    rs = np.random.RandomState(1)
    n = 6
    Q = rs.randn(n, n)
    Q = 0.5 * (Q + Q.T)
    e = rs.randn(n)
    d = bqpmom(n, Q, e)
    r64 = solve_unitdiag(d.At, d.b, d.c, d.K.s, verbose=False)
    rmx = solve_unitdiag(d.At, d.b, d.c, d.K.s, verbose=False,
                         inner_dtype="mixed")
    assert r64.status == 0 and rmx.status == 0
    assert rmx.eta < 1e-8
    assert abs(rmx.obj - r64.obj) / (1 + abs(r64.obj)) < 1e-6


def test_mixed_matches_f64():
    C = _random_laplacian_cost()
    r64 = solve_maxcut_unitdiag(C, p0=8, verbose=False)
    rmx = solve_maxcut_unitdiag(C, p0=8, verbose=False,
                                inner_dtype="mixed")
    assert r64.status == 0 and rmx.status == 0
    assert rmx.dinf < 1e-8
    assert abs(rmx.obj - r64.obj) / (1 + abs(r64.obj)) < 1e-7
    # the f32 stage contributes iterations, so the mixed run's counter
    # includes both stages
    assert rmx.hess_calls > 0


def _bqp_sos(n, seed):
    from manisdp.frontends.sos import assemble_bqpsos
    rs = np.random.RandomState(seed)
    Q = rs.randn(n, n)
    Q = 0.5 * (Q + Q.T)
    e = rs.randn(n)
    return assemble_bqpsos(Q, e, n)


def test_mixed_dual_unitdiag_matches_f64():
    from manisdp.solvers.dual_unitdiag import solve_dual_unitdiag

    A, b, c, mb, f, dAAt = _bqp_sos(6, 3)
    maxb = np.max(np.abs(b))
    kw = dict(f=f, dAAt=dAAt, line_search=True, verbose=False)
    r64 = solve_dual_unitdiag(A, b / maxb, c, mb, **kw)
    rmx = solve_dual_unitdiag(A, b / maxb, c, mb, inner_dtype="mixed",
                              **kw)
    assert r64.status == 0 and rmx.status == 0
    assert rmx.eta < 1e-8
    np.testing.assert_allclose(rmx.obj, r64.obj, rtol=1e-6)


def test_mixed_dual_general_matches_f64():
    from manisdp.frontends.monomials import monomial_basis
    from manisdp.frontends.sos import qssos
    from manisdp.solvers.dual_general import solve_dual_sdp

    n = 4
    rs = np.random.RandomState(4)
    coe = rs.randn(monomial_basis(n, 4).shape[1])
    A, b, c, mb, f, dAAt = qssos(n, coe)
    kw = dict(f=f, dAAt=dAAt, verbose=False)
    r64 = solve_dual_sdp(A, b, c, mb, **kw)
    rmx = solve_dual_sdp(A, b, c, mb, inner_dtype="mixed", **kw)
    assert r64.status == 0 and rmx.status == 0
    assert rmx.eta < 1e-8
    np.testing.assert_allclose(rmx.obj, r64.obj, rtol=1e-6)


def test_mixed_multiblock_matches_f64():
    import scipy.sparse as sp
    from manisdp.frontends.moments import bqpmom
    from manisdp.solvers.multiblock import solve_multiblock

    rs = np.random.RandomState(5)
    blocks = []
    for n, seed in ((5, 1), (4, 2)):
        Q = rs.randn(n, n)
        Q = 0.5 * (Q + Q.T)
        blocks.append(bqpmom(n, Q, rs.randn(n)))
    At = sp.block_diag([d.At for d in blocks]).tocsc()
    b = np.concatenate([d.b for d in blocks])
    c = np.concatenate([d.c for d in blocks])
    ns = [d.K.s for d in blocks]
    kw = dict(nob=2, verbose=False, sigma0=1e-3, sigma_min=1e-2,
              tau1=1, tau2=1)
    r64 = solve_multiblock(At, b, c, ns=ns, **kw)
    rmx = solve_multiblock(At, b, c, ns=ns, inner_dtype="mixed", **kw)
    assert r64.status == 0 and rmx.status == 0
    assert rmx.eta < 1e-8
    np.testing.assert_allclose(rmx.obj, r64.obj, rtol=1e-6)


def test_mixed_dual_multiblock_matches_f64():
    from manisdp.solvers.dual_multiblock import solve_dual_multiblock

    A, b, c, mb, f, dAAt = _bqp_sos(6, 6)
    maxb = np.max(np.abs(b))
    kw = dict(ns=[mb], nob=1, f=f, dAAt=dAAt, verbose=False,
              sigma0=1e-3, sigma_min=1e-3, tau1=1e1, tau2=1e2,
              theta=1e-3, alpha=0.1)
    r64 = solve_dual_multiblock(A, b / maxb, c, **kw)
    rmx = solve_dual_multiblock(A, b / maxb, c, inner_dtype="mixed", **kw)
    assert r64.status == 0 and rmx.status == 0
    assert rmx.eta < 1e-8
    np.testing.assert_allclose(rmx.obj, r64.obj, rtol=1e-6)


def test_batch_mixed_warns():
    import warnings
    from manisdp import solve_maxcut_batch

    Cs = np.stack([_random_laplacian_cost(16, s) for s in range(2)])
    with warnings.catch_warnings(record=True) as wrec:
        warnings.simplefilter("always")
        solve_maxcut_batch(Cs, verbose=False, inner_dtype="mixed",
                           max_outer=2, p0=4)
    assert any("mixed" in str(x.message) for x in wrec)


def test_tcg32_maxcut_matches_f64():
    """inner_dtype='tcg32' (f32 truncated-CG, f64 outer) must certify
    the same 1e-8 result — the tCG is just an inexact model solve.
    Force the SPARSE cost path (the one tcg32 applies to; the dense
    path keeps f64 tCG, see solvers/maxcut._make_inner)."""
    C = _random_laplacian_cost()
    kw = dict(p0=8, verbose=False, dense_cost_max_n=0,
              dense_cost_nnz_factor=0)
    r64 = solve_maxcut_unitdiag(C, inner_dtype="float64", **kw)
    r32 = solve_maxcut_unitdiag(C, inner_dtype="tcg32", **kw)
    assert r32.status == 0
    assert r32.dinf < 1e-8
    assert abs(r32.obj - r64.obj) / (1 + abs(r64.obj)) < 1e-7


def test_tcg32_al_driver_matches_f64():
    from manisdp import solve_unitdiag
    from manisdp.frontends.moments import bqpmom

    rs = np.random.RandomState(1)
    n = 6
    Q = rs.randn(n, n)
    Q = 0.5 * (Q + Q.T)
    e = rs.randn(n)
    d = bqpmom(n, Q, e)
    r64 = solve_unitdiag(d.At, d.b, d.c, d.K.s, verbose=False)
    r32 = solve_unitdiag(d.At, d.b, d.c, d.K.s, verbose=False,
                         inner_dtype="tcg32")
    assert r32.status == 0
    assert r32.eta < 1e-8
    assert abs(r32.obj - r64.obj) / (1 + abs(r64.obj)) < 1e-6


def test_tcg32_dual_driver_matches_f64():
    from manisdp.solvers.dual_unitdiag import solve_dual_unitdiag

    A, b, c, mb, f, dAAt = _bqp_sos(6, 3)
    maxb = np.max(np.abs(b))
    kw = dict(f=f, dAAt=dAAt, line_search=True, verbose=False)
    r64 = solve_dual_unitdiag(A, b / maxb, c, mb, **kw)
    r32 = solve_dual_unitdiag(A, b / maxb, c, mb, inner_dtype="tcg32",
                              **kw)
    assert r32.status == 0
    assert r32.eta < 1e-8
    np.testing.assert_allclose(r32.obj, r64.obj, rtol=1e-6)
