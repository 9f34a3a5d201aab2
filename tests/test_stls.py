"""STLS (nearest rank-deficient Hankel) end-to-end: certified solve via
the "stls" recipe + tightness/extraction oracle + agreement with an
independent alternating local optimizer (reference example/example_stls.m)."""

import numpy as np

from manisdp import solve_sdp
from manisdp.frontends.stls import (extract_solution, hankel_matrix,
                                    nearest_hankel_sdp, stls_objective)
from manisdp.recipes import recipe


def _f_of_z(z, u1, n1, n2):
    """Variable-projection objective: min_u ||u-u1||^2 s.t. z'H(u)=0 has
    the closed form u = u1 - M'(MM')^{-1}M u1 with M(z)[c, t] =
    sum_{r: r+c=t} z_r, so f(z) = u1'M'(MM')^{-1}M u1."""
    k = n1 + n2 - 1
    z = np.asarray(z, dtype=np.float64)
    z = z / np.linalg.norm(z)
    M = np.zeros((n2, k))
    for c in range(n2):
        for r in range(n1):
            M[c, r + c] += z[r]
    lam = np.linalg.solve(M @ M.T, M @ u1)
    return float(u1 @ (M.T @ lam))


def test_stls_certified_and_tight():
    n1 = n2 = 4
    k = n1 + n2 - 1
    rs = np.random.RandomState(1)
    u1 = rs.randn(k)

    data = nearest_hankel_sdp(u1, n1, n2)
    _, kw = recipe("stls")
    res = solve_sdp(data.At, data.b, data.c, data.K.s, verbose=False,
                    max_outer=500, **kw)
    assert res.status == 0, f"stls stalled: eta={res.eta:.2e}"
    assert res.eta < 1e-8

    val = stls_objective(res.obj, u1)
    u, z, resid = extract_solution(res.X, n1, n2)
    # rank-one tightness: extracted point is feasible and matches the
    # SDP value
    assert resid < 1e-5
    np.testing.assert_allclose(np.sum((u - u1) ** 2), val,
                               rtol=1e-5, atol=1e-7)

    # global-optimality sandwich: (1) the SDP value is a LOWER bound on
    # every feasible (u, z), checked against an independent local
    # optimizer from many restarts; (2) the extracted z ACHIEVES the SDP
    # value through the variable-projection objective — so val == f*.
    from scipy.optimize import minimize
    best = np.inf
    for s in range(12):
        z0 = np.random.RandomState(s).randn(n1)
        r = minimize(_f_of_z, z0, args=(u1, n1, n2), method="BFGS")
        best = min(best, float(r.fun))
    assert val <= best + 1e-6
    np.testing.assert_allclose(_f_of_z(z, u1, n1, n2), val,
                               rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(val, best, rtol=1e-4, atol=1e-6)


def test_stls_recipe_registered():
    solver, kw = recipe("stls")
    assert solver == "general"
    assert kw["tau1"] == 1e-2 and kw["tau2"] == 1e2
