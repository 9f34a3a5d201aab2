"""Row-layout host-RR LOBPCG certificate (ops/eigs_rr.py) unit tests.

The certificate replaces the reference's full eig of the dual matrix
(ManiSDP_onlyunitdiag.m:50); soundness contract: the reported lam_min
is a residual-backed LOWER bound of the true lambda_min.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from manisdp.ops.eigs_rr import (DeviceCertSolver, RowCertSolver,
                                 lobpcg_rows)


@pytest.fixture(scope="module")
def sym():
    rs = np.random.RandomState(7)
    n = 300
    A = rs.randn(n, n)
    S = (A + A.T) / 2
    return n, S, np.linalg.eigvalsh(S)


def test_bottom_eigs_match(sym):
    n, S, ref = sym
    k = 5
    Sd = jnp.asarray(S)
    res = lobpcg_rows(lambda V: V @ Sd, n, k, jax.random.PRNGKey(0),
                      maxiter=200, tol=1e-10)
    np.testing.assert_allclose(np.asarray(res.neg_vals), ref[:k],
                               atol=1e-8)
    assert float(res.lam_min) <= ref[0] + 1e-9       # lower bound
    assert float(res.lam_max) >= ref[-1] - 1e-6      # upper estimate
    V = np.asarray(res.neg_vecs)
    r0 = np.linalg.norm(S @ V[:, 0] - ref[0] * V[:, 0])
    assert r0 < 1e-7


def test_f32_stage_and_warm_start_stay_sound(sym):
    n, S, ref = sym
    k = 5
    Sd = jnp.asarray(S)
    Sf = Sd.astype(jnp.float32)
    solver = RowCertSolver(lambda V, ctx: V @ ctx, n,
                           lambda V, ctx: V @ ctx)
    X0 = None
    for shift in (0.0, 0.3):
        St = Sd - shift * jnp.eye(n)
        res = solver.solve(St, jax.random.PRNGKey(1), k, X0=X0,
                           maxiter=200, tol=1e-10)
        ref_t = ref - shift
        np.testing.assert_allclose(np.asarray(res.neg_vals), ref_t[:k],
                                   atol=1e-7)
        assert float(res.lam_min) <= ref_t[0] + 1e-9
        X0 = res.neg_vecs


def test_device_solver_matches_eigh(sym):
    n, S, ref = sym
    k = 5
    Sd = jnp.asarray(S)
    solver = DeviceCertSolver(lambda V, ctx: V @ ctx, n, k)
    res = solver.solve(Sd, jax.random.PRNGKey(0), maxiter=300, tol=1e-10)
    np.testing.assert_allclose(np.asarray(res.neg_vals), ref[:k],
                               atol=1e-8)
    assert float(res.lam_min) <= ref[0] + 1e-9       # lower bound
    assert float(res.lam_max) >= ref[-1] - 1e-6
    V = np.asarray(res.neg_vecs)
    r0 = np.linalg.norm(S @ V[:, 0] - ref[0] * V[:, 0])
    assert r0 < 1e-7
    assert int(res.num_neg) == int(np.sum(ref[:k] < 0)) or \
        int(res.num_neg) <= np.sum(ref < 0)


def test_device_solver_warm_start_and_budget(sym):
    n, S, ref = sym
    k = 5
    Sd = jnp.asarray(S)
    solver = DeviceCertSolver(lambda V, ctx: V @ ctx, n, k)
    res = solver.solve(Sd, jax.random.PRNGKey(1), maxiter=250, tol=1e-10)
    # warm restart with a runtime (non-recompiling) budget change
    res2 = solver.solve(Sd - 0.3 * jnp.eye(n), jax.random.PRNGKey(2),
                        X0=res.neg_vecs, maxiter=40, tol=1e-10)
    np.testing.assert_allclose(np.asarray(res2.neg_vals), ref[:k] - 0.3,
                               atol=1e-6)
    assert float(res2.lam_min) <= ref[0] - 0.3 + 1e-9


def test_device_solver_deflation_padded_factor():
    # deflation through a zero-padded factor (the cert_p_bucket layout
    # the drivers pass): padding rows must drop out via the good-mask
    rs = np.random.RandomState(3)
    n = 300
    Y = rs.randn(6, n)
    S = Y.T @ Y + 1e-6 * np.diag(rs.rand(n)) - 0.5 * np.eye(n)
    ref = np.linalg.eigvalsh(S)
    Ypad = np.zeros((16, n))
    Ypad[:6] = Y
    solver = DeviceCertSolver(lambda V, ctx: V @ ctx, n, 4,
                              deflate_rows=16)
    res = solver.solve(jnp.asarray(S), jax.random.PRNGKey(2),
                       Ypad=jnp.asarray(Ypad), maxiter=300, tol=1e-10)
    assert abs(float(res.neg_vals[0]) - ref[0]) < 1e-5
    assert float(res.lam_min) <= ref[0] + 1e-9


def test_deflation_resolves_near_null_cluster(sym):
    # S = G'G - mu I has a dense near-null cluster spanned by the
    # complement; deflating with the factor rows still finds the
    # bottom eigenvalue (the hard case for the escape certificate)
    rs = np.random.RandomState(3)
    n = 300
    Y = rs.randn(6, n)
    S = Y.T @ Y + 1e-6 * np.diag(rs.rand(n)) - 0.5 * np.eye(n)
    ref = np.linalg.eigvalsh(S)
    res = lobpcg_rows(lambda V: V @ jnp.asarray(S), n, 4,
                      jax.random.PRNGKey(2), maxiter=300, tol=1e-10,
                      deflate=jnp.asarray(Y))
    # the bottom cluster is ~294-fold degenerate: Ritz values land
    # anywhere within ~resid of the cluster edge — the certificate
    # contract is the LOWER bound, asserted tightly below
    assert abs(float(res.neg_vals[0]) - ref[0]) < 1e-5
    assert float(res.lam_min) <= ref[0] + 1e-9


@pytest.mark.parametrize("scale", [1e-200, 1e200])
def test_device_solver_ieee_range(sym, scale):
    # the norm floors are IEEE-f64 ones: a spectrum far from 1 in
    # either direction is certified without underflow/overflow
    n, S, ref = sym
    k = 5
    solver = DeviceCertSolver(lambda V, ctx: V @ ctx, n, k)
    res = solver.solve(jnp.asarray(scale * S), jax.random.PRNGKey(0),
                       maxiter=300, tol=1e-10)
    vals = np.asarray(res.neg_vals) / scale
    assert np.all(np.isfinite(vals))
    np.testing.assert_allclose(vals, ref[:k], atol=1e-8)
    lam = float(res.lam_min) / scale
    assert np.isfinite(lam)
    assert lam <= ref[0] + 1e-9                      # lower bound


def test_device_solver_wide_block():
    # blocks wider than 42 rows (3b >= 129 Rayleigh-Ritz eighs) run
    rs = np.random.RandomState(5)
    n, k = 400, 48
    A = rs.randn(n, n)
    S = (A + A.T) / 2
    ref = np.linalg.eigvalsh(S)
    solver = DeviceCertSolver(lambda V, ctx: V @ ctx, n, k)
    assert solver.b == k
    res = solver.solve(jnp.asarray(S), jax.random.PRNGKey(3), maxiter=300,
                       tol=1e-10)
    np.testing.assert_allclose(np.asarray(res.neg_vals)[:8], ref[:8],
                               atol=1e-7)
    assert float(res.lam_min) <= ref[0] + 1e-9
