"""Cross-solver validation (SURVEY §4.2): the manifold drivers vs an
independent in-repo interior-point method on the same SeDuMi data, plus
round-trip validation of the MOSEK-task converter artifacts — the
equivalent of the reference's commented MOSEK/SDPLR baseline blocks
(example_maxcut.m:38-85)."""

import numpy as np
import scipy.sparse as sp

from manisdp import solve_maxcut_unitdiag, solve_sdp, solve_unitdiag
from manisdp.frontends.convert import (mosek_task_constraints,
                                       mosek_task_objective,
                                       recover_mosek_sol_blk,
                                       sedumi_to_mosek,
                                       triangle_number)
from manisdp.frontends.moments import bqpmom
from manisdp.frontends.sedumi import Cone, SedumiData
from manisdp.utils.ipm import solve_sdp_ipm


def diag_constraints(n):
    rows = np.arange(n) * n + np.arange(n)
    At = sp.coo_matrix((np.ones(n), (rows, np.arange(n))),
                       shape=(n * n, n)).tocsc()
    return At, np.ones(n)


def test_maxcut_vs_ipm():
    n = 12
    rs = np.random.RandomState(2)
    B = rs.randn(n, n)
    C = 0.5 * (B + B.T)
    np.fill_diagonal(C, 0.0)
    At, b = diag_constraints(n)

    res = solve_maxcut_unitdiag(C, verbose=False)
    ipm = solve_sdp_ipm(At, b, C.reshape(-1, order="F"), n)
    assert res.status == 0 and ipm.gap < 1e-9
    np.testing.assert_allclose(res.obj, ipm.obj, rtol=1e-7, atol=1e-7)


def test_bqp_moment_vs_ipm():
    n = 5
    rs = np.random.RandomState(4)
    Q = rs.randn(n, n)
    Q = 0.5 * (Q + Q.T)
    e = rs.randn(n)
    d = bqpmom(n, Q, e)

    res = solve_unitdiag(d.At, d.b, d.c, d.K.s, verbose=False)
    ipm = solve_sdp_ipm(d.At, d.b, d.c, d.K.s, tol=1e-10)
    assert res.status == 0 and ipm.gap < 1e-9
    np.testing.assert_allclose(res.obj, ipm.obj, rtol=1e-6, atol=1e-7)
    # and the duals agree through the common KKT metric
    assert ipm.pinf < 1e-9 and res.pinf < 1e-8


def test_theta_vs_ipm():
    """Lovasz theta of C5 through three independent routes: the sphere
    manifold driver, the IPM, and the closed form sqrt(5)."""
    n, edges = 5, [(0, 1), (1, 2), (2, 3), (3, 4), (0, 4)]
    m = len(edges)
    ei = np.array([e[0] for e in edges])
    ej = np.array([e[1] for e in edges])
    rows = np.concatenate([ei * n + ej, ej * n + ei,
                           np.arange(n) * n + np.arange(n)])
    cols = np.concatenate([np.arange(m), np.arange(m), np.full(n, m)])
    At = sp.coo_matrix(
        (np.concatenate([np.ones(2 * m), np.ones(n)]), (rows, cols)),
        shape=(n * n, m + 1)).tocsc()
    b = np.zeros(m + 1)
    b[m] = 1.0
    c = -np.ones(n * n)

    ipm = solve_sdp_ipm(At, b, c, n)
    np.testing.assert_allclose(-ipm.obj, np.sqrt(5.0), rtol=1e-8)

    from manisdp import solve_unittrace
    res = solve_unittrace(At[:, :m], b[:m], c, n, verbose=False,
                          max_outer=500)
    assert res.status == 0
    np.testing.assert_allclose(res.obj, ipm.obj, rtol=1e-7)


def test_mosek_task_roundtrip():
    """The emitted MOSEK task must reproduce the SeDuMi objective and
    constraint values on the solver's own solution, and
    recover_mosek_sol_blk must invert the bar-triangle packing."""
    n = 6
    rs = np.random.RandomState(7)
    B = rs.randn(n, n)
    C = 0.5 * (B + B.T)
    np.fill_diagonal(C, 0.0)
    At, b = diag_constraints(n)
    c = C.reshape(-1, order="F")
    data = SedumiData(At=At, b=b, c=c, K=Cone(s=n))

    res = solve_maxcut_unitdiag(C, verbose=False)
    task = sedumi_to_mosek(data)
    # objective / constraints recomputed ONLY from the task triplets
    np.testing.assert_allclose(
        mosek_task_objective(task, [res.X]), res.obj, rtol=1e-10)
    np.testing.assert_allclose(
        mosek_task_constraints(task, [res.X]), b, atol=1e-7)

    # pack (X, S) the way MOSEK reports them, then recover
    tril_r, tril_c = np.tril_indices(n)
    S = res.S if res.S is not None else np.eye(n)
    fake_res = {"sol": {"itr": {
        "barx": res.X[tril_r, tril_c],
        "bars": S[tril_r, tril_c],
        "xx": np.zeros(0),
        "y": res.z if res.z is not None else np.zeros(n),
        "pobjval": res.obj, "dobjval": res.obj,
    }}}
    X_blocks, y, S_blocks, obj = recover_mosek_sol_blk(fake_res,
                                                       Cone(s=n))
    np.testing.assert_allclose(X_blocks[0], res.X, atol=1e-12)
    np.testing.assert_allclose(S_blocks[0], S, atol=1e-12)
    assert obj[0] == res.obj
