"""Unit-Frobenius-norm sphere of (p, n) matrices.

Equivalent of Manopt's ``spherefactory(n, p)``
(manopt7.0/manopt/manifolds/sphere/spherefactory.m) — the reference uses
it with Y of shape (n, p) (ManiSDP_unittrace.m:53); we keep the rank
axis leading like every other manifold here.  The manifold is
layout-agnostic: it only sees the flattened vector.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .base import frob_inner, frob_norm


class Sphere:
    name = "sphere"

    inner = staticmethod(frob_inner)
    norm = staticmethod(frob_norm)

    @staticmethod
    def proj(x, u):
        # d - x * <x, d>  (spherefactory.m:113)
        return u - x * jnp.sum(x * u)

    tangent = proj

    @staticmethod
    def transp(x1, x2, d):
        return d - x2 * jnp.sum(x2 * d)

    @staticmethod
    def retr(x, d):
        xtd = x + d
        return xtd / jnp.sqrt(jnp.sum(xtd * xtd))

    @staticmethod
    def zerovec(x):
        return jnp.zeros_like(x)

    @staticmethod
    def typicaldist(p, n):
        return jnp.pi

    @staticmethod
    def rand(key, p, n, p_pad=None, dtype=jnp.float64):
        p_pad = p if p_pad is None else p_pad
        y = jax.random.normal(key, (p, n), dtype=dtype)
        y = y / jnp.sqrt(jnp.sum(y * y))
        if p_pad > p:
            y = jnp.concatenate(
                [y, jnp.zeros((p_pad - p, n), dtype=dtype)], axis=0)
        return y

    @staticmethod
    def renormalize(y):
        return y / jnp.sqrt(jnp.sum(y * y))
