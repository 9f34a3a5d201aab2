"""Property tests for manifold geometry ops (SURVEY §4: per-op unit
tests — tangency, retraction feasibility, padding invariance)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from manisdp.manifolds import Euclidean, Oblique, Sphere

KEY = jax.random.PRNGKey(0)
P, N = 3, 17
PAD = 8


@pytest.mark.parametrize("M", [Oblique, Sphere, Euclidean])
def test_rand_on_manifold(M):
    y = M.rand(KEY, P, N)
    if M is Oblique:
        np.testing.assert_allclose(np.sum(np.asarray(y) ** 2, axis=0), 1.0,
                                   atol=1e-12)
    elif M is Sphere:
        np.testing.assert_allclose(float(jnp.sum(y * y)), 1.0, atol=1e-12)


@pytest.mark.parametrize("M", [Oblique, Sphere, Euclidean])
def test_proj_is_tangent_and_idempotent(M):
    k1, k2 = jax.random.split(KEY)
    x = M.rand(k1, P, N)
    u = jax.random.normal(k2, (P, N), dtype=jnp.float64)
    t = M.proj(x, u)
    # idempotent
    np.testing.assert_allclose(np.asarray(M.proj(x, t)), np.asarray(t),
                               atol=1e-12)
    # tangency: d/dt constraint(retr(x, t*eps)) == 0
    if M is Oblique:
        np.testing.assert_allclose(np.sum(np.asarray(x * t), axis=0), 0.0,
                                   atol=1e-12)
    elif M is Sphere:
        assert abs(float(jnp.sum(x * t))) < 1e-12


@pytest.mark.parametrize("M", [Oblique, Sphere, Euclidean])
def test_retraction_feasible(M):
    k1, k2 = jax.random.split(KEY)
    x = M.rand(k1, P, N)
    d = M.proj(x, 0.1 * jax.random.normal(k2, (P, N), dtype=jnp.float64))
    y = M.retr(x, d)
    if M is Oblique:
        np.testing.assert_allclose(np.sum(np.asarray(y) ** 2, axis=0), 1.0,
                                   atol=1e-12)
    elif M is Sphere:
        np.testing.assert_allclose(float(jnp.sum(y * y)), 1.0, atol=1e-12)


@pytest.mark.parametrize("M", [Oblique, Sphere, Euclidean])
def test_padding_invariance(M):
    """Ops on a zero-padded factor equal ops on the active slice."""
    k1, k2 = jax.random.split(KEY)
    x = M.rand(k1, P, N)
    u = jax.random.normal(k2, (P, N), dtype=jnp.float64)
    xp = jnp.concatenate([x, jnp.zeros((PAD - P, N))], axis=0)
    up = jnp.concatenate([u, jnp.zeros((PAD - P, N))], axis=0)

    t = M.proj(x, u)
    tp = M.proj(xp, up)
    np.testing.assert_allclose(np.asarray(tp[:P]), np.asarray(t), atol=1e-12)
    np.testing.assert_allclose(np.asarray(tp[P:]), 0.0, atol=1e-15)

    y = M.retr(x, M.proj(x, u))
    yp = M.retr(xp, M.proj(xp, up))
    np.testing.assert_allclose(np.asarray(yp[:P]), np.asarray(y), atol=1e-12)
    np.testing.assert_allclose(np.asarray(yp[P:]), 0.0, atol=1e-15)


def test_rand_padded_zero_rows():
    for M in (Oblique, Sphere, Euclidean):
        y = M.rand(KEY, P, N, p_pad=PAD)
        assert y.shape == (PAD, N)
        np.testing.assert_allclose(np.asarray(y[P:]), 0.0)
