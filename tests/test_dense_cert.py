"""Property tests for ops/eigs.dense_certificate, the dense dual
certificate (one device f64 eigh): it must reproduce np.linalg.eigh on
matrices with planted near-zero clusters — the structure the SOS-dual
primal recovery matrix has at its optimum (rank-r positive part plus an
(n-r)-fold near-zero cluster; see solvers/dual_al.py exact_cert)."""

import jax.numpy as jnp
import numpy as np
import pytest

from manisdp.ops.eigs import dense_certificate


def _planted(n, r, cluster_spread, neg=0.0, seed=0):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lam = np.concatenate([
        np.sort(rng.uniform(0.0, cluster_spread, size=n - r))
        - neg,
        np.sort(rng.uniform(1.0, 50.0, size=r)),
    ])
    X = (Q * lam) @ Q.T
    X = (X + X.T) / 2
    return X, np.sort(lam)


@pytest.mark.parametrize("n,r", [(200, 3), (400, 17)])
def test_certifies_planted_cluster(n, r):
    X, lam = _planted(n, r, cluster_spread=1e-10, seed=1)
    res = dense_certificate(jnp.asarray(X), 9)
    ref = np.linalg.eigvalsh(X)
    scale = 1.0 + abs(lam[-1])
    assert abs(float(res.lam_min) - ref[0]) <= 1e-12 * scale
    assert abs(float(res.lam_max) - ref[-1]) <= 1e-12 * scale
    np.testing.assert_allclose(np.asarray(res.neg_vals), ref[:9],
                               atol=1e-12 * scale)


def test_detects_negative_eigenvalue():
    n, r = 300, 5
    X, lam = _planted(n, r, cluster_spread=1e-10, neg=3e-6, seed=2)
    res = dense_certificate(jnp.asarray(X), 9)
    # dinf from the certificate must see the planted negative shift
    # (~3e-6 over lam_max ~ 50) above a 1e-8 tolerance
    dinf = max(0.0, -float(res.lam_min)) / (1.0 + abs(float(res.lam_max)))
    assert dinf > 1e-8
    assert int(res.num_neg) == int(np.sum(np.linalg.eigvalsh(X) < 0))
    # escape vectors: the lowest one is an eigenvector of X
    v = np.asarray(res.neg_vecs)[:, 0]
    mu = float(v @ X @ v)
    assert np.linalg.norm(X @ v - mu * v) <= 1e-10 * (1.0 + abs(lam[-1]))
    assert mu < 0


def test_escape_vectors_orthonormal_and_shapes():
    n, r = 256, 4
    X, _ = _planted(n, r, cluster_spread=1e-4, seed=3)
    res = dense_certificate(jnp.asarray(X), 9)
    V = np.asarray(res.neg_vecs)
    assert V.shape == (n, 9) and np.asarray(res.neg_vals).shape == (9,)
    np.testing.assert_allclose(V.T @ V, np.eye(9), atol=1e-12)


def test_random_dense_matches_numpy_and_symmetrizes():
    rng = np.random.default_rng(4)
    n = 257
    A = rng.standard_normal((n, n))
    X = (A + A.T) / 2
    lam = np.linalg.eigvalsh(X)
    # an unsymmetric input is certified through its symmetric part
    res = dense_certificate(jnp.asarray(X + 1e-3 * (A - A.T)), 5)
    scale = 1.0 + abs(lam[-1])
    assert abs(float(res.lam_min) - lam[0]) <= 1e-12 * scale
    assert int(res.num_neg) == int(np.sum(lam < 0))
