"""Oblique manifold in transposed (p, n) layout: unit-norm columns.

Equivalent of the reference's inline ``obliquefactoryNTrans``
(src/primal/ManiSDP_unitdiag.m:173-198): points are p-by-n matrices whose
n columns have unit Euclidean norm; the metric is the ambient Frobenius
inner product.

All ops are column-wise and vectorize over the trailing dimension n.
Zero padding rows are preserved by every op (column sums ignore them).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .base import frob_inner, frob_norm


class Oblique:
    name = "oblique"

    inner = staticmethod(frob_inner)
    norm = staticmethod(frob_norm)

    @staticmethod
    def proj(x, u):
        # U - X .* sum(X .* U) columnwise (ManiSDP_unitdiag.m:180)
        return u - x * jnp.sum(x * u, axis=0, keepdims=True)

    tangent = proj

    @staticmethod
    def transp(x1, x2, d):
        return d - x2 * jnp.sum(x2 * d, axis=0, keepdims=True)

    @staticmethod
    def retr(x, d):
        # metric-projection retraction: column-normalize x + d
        # (ManiSDP_unitdiag.m:184-187)
        xtd = x + d
        return xtd / jnp.sqrt(jnp.sum(xtd * xtd, axis=0, keepdims=True))

    @staticmethod
    def zerovec(x):
        return jnp.zeros_like(x)

    @staticmethod
    def typicaldist(p, n):
        # pi * sqrt(n), independent of rank (ManiSDP_unitdiag.m:179)
        return jnp.pi * jnp.sqrt(float(n))

    @staticmethod
    def rand(key, p, n, p_pad=None, dtype=jnp.float64):
        """Column-normalized Gaussian point, zero-padded to p_pad rows."""
        p_pad = p if p_pad is None else p_pad
        y = jax.random.normal(key, (p, n), dtype=dtype)
        y = y / jnp.sqrt(jnp.sum(y * y, axis=0, keepdims=True))
        if p_pad > p:
            y = jnp.concatenate(
                [y, jnp.zeros((p_pad - p, n), dtype=dtype)], axis=0)
        return y

    @staticmethod
    def renormalize(y):
        """Project a (possibly padded) factor back onto the manifold."""
        return y / jnp.sqrt(jnp.sum(y * y, axis=0, keepdims=True))
