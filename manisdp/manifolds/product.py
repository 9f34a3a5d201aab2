"""Masked product manifold: the multiblock geometry in one factor.

The reference's ``multiblockmanifold`` (src/basicfunction/multiblockmanifold.m
+ the C MEX kernels in src/C-files/) holds a cell array of per-block
factors {Y_i in R^{p_i x n_i}}, the first ``nob`` on oblique manifolds
(unit columns) and the rest Euclidean, and loops over blocks in C.

Here the product collapses into ONE flat factor Y of shape
(p_max, N), N = sum n_i, whose column groups are the blocks (each
padded with zero rows beyond its active rank p_i).  Because every
manifold operation of the product is column-local — oblique projection
/ retraction act per column, Euclidean ones are the identity — the
whole product reduces to masked column-wise ops:

    proj(Y, U) = U - Y * (colsum(Y*U) * mask)
    retr(Y, D) = (Y+D) / where(mask, colnorm(Y+D), 1)

with mask[j] = 1 for columns of oblique blocks.  No per-block loops,
no MEX kernels: one fused elementwise pass over (p_max, N).

NB: the shipped projc.cpp/retrc.cpp sources disagree with the
pure-MATLAB oblique semantics (SURVEY §2.3 — stale sphere-style
projection and unconditional normalization); we implement the
mathematically correct per-column behavior used by the MATLAB drivers.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .base import frob_inner, frob_norm


class MaskedProduct:
    """Instance-based manifold; ``mask`` is a (N,) 0/1 float array."""

    name = "masked_product"

    def __init__(self, mask):
        self.mask = jnp.asarray(mask, dtype=jnp.float64)

    inner = staticmethod(frob_inner)
    norm = staticmethod(frob_norm)

    def _mask(self, like):
        # match the operand dtype so the same manifold instance serves
        # both the f64 path and the f32 mixed-precision pre-stage
        return self.mask.astype(like.dtype)[None, :]

    def proj(self, x, u):
        return u - x * (jnp.sum(x * u, axis=0, keepdims=True)
                        * self._mask(x))

    def tangent(self, x, u):
        return self.proj(x, u)

    def transp(self, x1, x2, d):
        return self.proj(x2, d)

    def retr(self, x, d):
        xtd = x + d
        nrm = jnp.sqrt(jnp.sum(xtd * xtd, axis=0, keepdims=True))
        denom = jnp.where(self._mask(xtd) > 0, nrm, 1.0)
        return xtd / denom

    def zerovec(self, x):
        return jnp.zeros_like(x)

    def renormalize(self, y):
        nrm = jnp.sqrt(jnp.sum(y * y, axis=0, keepdims=True))
        denom = jnp.where(self._mask(y) > 0, nrm, 1.0)
        return y / denom

    @staticmethod
    def typicaldist(ns, ps, nob):
        """sqrt(pi * sum n_oblique + sum p_e * n_e)
        (multiblockmanifold.m:12-15); depends on the CURRENT Euclidean
        block ranks, so recomputed per outer iteration on host."""
        ns = np.asarray(ns)
        ps = np.asarray(ps)
        return float(np.sqrt(np.pi * ns[:nob].sum()
                             + float(ps[nob:] @ ns[nob:])))
