"""Generic Lasserre relaxation: moment feasibility + agreement with the
specialized qsmom / bqpmom generators."""

import numpy as np

from manisdp import solve_sdp, solve_unitdiag
from manisdp.frontends.lasserre import (dense_sdp_relax,
                                        poly_from_arrays)
from manisdp.frontends.moments import bqpmom, qsmom
from manisdp.frontends.monomials import monomial_basis


def eval_basis(basis, x):
    return np.prod(x[:, None] ** basis, axis=0)


def test_moment_feasibility_sphere():
    n, kappa = 3, 2
    rs = np.random.RandomState(0)
    b4 = monomial_basis(n, 4)
    coe = rs.randn(b4.shape[1])
    obj = poly_from_arrays(b4, coe)
    h = poly_from_arrays(
        np.concatenate([2 * np.eye(n, dtype=np.int64),
                        np.zeros((n, 1), dtype=np.int64)], axis=1),
        np.concatenate([np.ones(n), [-1.0]]))
    data = dense_sdp_relax(obj, [h], n, kappa)

    basis2 = monomial_basis(n, 2)
    for _ in range(4):
        x = rs.randn(n)
        x /= np.linalg.norm(x)
        m = eval_basis(basis2, x)
        X = np.outer(m, m)
        np.testing.assert_allclose(data.At.T @ X.flatten(order="F"),
                                   data.b, atol=1e-12)
        np.testing.assert_allclose(float(data.c @ X.flatten(order="F")),
                                   coe @ eval_basis(b4, x), atol=1e-10)


def test_matches_qsmom_optimum():
    n = 3
    rs = np.random.RandomState(1)
    b4 = monomial_basis(n, 4)
    coe = rs.randn(b4.shape[1])
    ref = qsmom(n, coe)
    res_ref = solve_sdp(ref.At, ref.b, ref.c, ref.K.s, verbose=False,
                        theta=1e-2, tau1=0.02)

    obj = poly_from_arrays(b4, coe)
    h = poly_from_arrays(
        np.concatenate([2 * np.eye(n, dtype=np.int64),
                        np.zeros((n, 1), dtype=np.int64)], axis=1),
        np.concatenate([np.ones(n), [-1.0]]))
    data = dense_sdp_relax(obj, [h], n, 2)
    res = solve_sdp(data.At, data.b, data.c, data.K.s, verbose=False,
                    theta=1e-2, tau1=0.02)
    assert res.status == 0
    np.testing.assert_allclose(res.obj, res_ref.obj, rtol=1e-6)


def test_binary_matches_bqpmom_optimum():
    n = 5
    rs = np.random.RandomState(2)
    Q = rs.randn(n, n)
    Q = 0.5 * (Q + Q.T)
    e = rs.randn(n)
    ref = bqpmom(n, Q, e)
    res_ref = solve_unitdiag(ref.At, ref.b, ref.c, ref.K.s, verbose=False)

    # objective x'Qx + e'x as a Poly (with x_i^2 -> 1 reduction handled
    # by the binary relaxation itself)
    exps, coeffs = [], []
    for i in range(n):
        for j in range(n):
            t = np.zeros(n, dtype=np.int64)
            t[i] += 1
            t[j] += 1
            exps.append(t)
            coeffs.append(Q[i, j])
    for i in range(n):
        t = np.zeros(n, dtype=np.int64)
        t[i] = 1
        exps.append(t)
        coeffs.append(e[i])
    obj_raw = poly_from_arrays(np.stack(exps, axis=1), coeffs)
    # reduce exponents mod 2 (binary variables)
    obj = {}
    for ee, cv in obj_raw.items():
        key = tuple(x % 2 for x in ee)
        obj[key] = obj.get(key, 0.0) + cv
    data = dense_sdp_relax(obj, [], n, 2, binary=True)
    res = solve_unitdiag(data.At, data.b, data.c, data.K.s, verbose=False)
    assert res.status == 0
    np.testing.assert_allclose(res.obj, res_ref.obj, rtol=1e-6)
