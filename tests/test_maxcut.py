"""End-to-end MaxCut solves, verified by the external KKT oracle.

The oracle (SURVEY §4.1) is computed OUTSIDE the solver from raw
(X, z, S) with dense numpy: primal feasibility diag(X)=1, dual
feasibility lambda_min(S) >= -tol, and complementarity <C,X> = sum(z).
"""

import numpy as np
import pytest
import scipy.sparse as sp

from manisdp import SolverOptions, solve_maxcut_unitdiag


def random_graph_cost(n, m_edges, seed):
    rs = np.random.RandomState(seed)
    i = rs.randint(0, n, size=m_edges)
    j = rs.randint(0, n, size=m_edges)
    keep = i != j
    i, j = i[keep], j[keep]
    w = np.ones(len(i))
    W = sp.coo_matrix((np.r_[w, w], (np.r_[i, j], np.r_[j, i])),
                      shape=(n, n)).tocsr()
    W.sum_duplicates()
    deg = np.asarray(W.sum(axis=1)).ravel()
    L = sp.diags(deg) - W
    return (-0.25) * L


def kkt_oracle(C_dense, res, tol):
    X = res.X
    n = X.shape[0]
    # primal feasibility: diag(X) = 1 (exact by manifold construction)
    pinf = np.max(np.abs(np.diag(X) - 1.0))
    z = np.sum(C_dense * X, axis=0)
    S = C_dense - np.diag(z)
    w = np.linalg.eigvalsh(S)
    dinf = max(0.0, -w[0]) / (1.0 + w[-1])
    obj = float(np.sum(C_dense * X))
    comp = abs(obj - np.sum(z)) / (1 + abs(obj))
    return max(pinf, dinf, comp), obj


def test_maxcut_small_eigh():
    C = random_graph_cost(60, 300, seed=0)
    res = solve_maxcut_unitdiag(C, verbose=False, eig_method="eigh")
    eta, obj = kkt_oracle(C.toarray(), res, 1e-8)
    assert res.status == 0
    assert eta < 1e-8
    np.testing.assert_allclose(obj, res.obj, rtol=1e-10)


def test_maxcut_lobpcg_matches_eigh():
    C = random_graph_cost(80, 400, seed=1)
    res_e = solve_maxcut_unitdiag(C, verbose=False, eig_method="eigh")
    res_l = solve_maxcut_unitdiag(C, verbose=False, eig_method="lobpcg")
    assert res_l.status == 0
    eta, _ = kkt_oracle(C.toarray(), res_l, 1e-8)
    assert eta < 1e-8
    np.testing.assert_allclose(res_l.obj, res_e.obj, rtol=1e-7)


def test_maxcut_line_search_path():
    C = random_graph_cost(50, 200, seed=2)
    res = solve_maxcut_unitdiag(C, verbose=False, line_search=True)
    eta, _ = kkt_oracle(C.toarray(), res, 1e-8)
    assert eta < 1e-8


def test_maxcut_warm_start():
    C = random_graph_cost(40, 150, seed=3)
    res1 = solve_maxcut_unitdiag(C, verbose=False)
    res2 = solve_maxcut_unitdiag(C, verbose=False, Y0=res1.Y)
    assert res2.iterations <= res1.iterations
    assert res2.status == 0
