"""Manifold protocol for the RTR core.

A manifold here is a namespace of *pure functions* acting on a factor
``Y`` of shape ``(p_pad, n)``: the large axis ``n`` is the trailing
(contiguous) dimension, the small rank axis leads.  Rank
padding rows of ``Y`` are zero and every operation below maps zero rows
to zero rows, so a padded factor behaves exactly like its active slice.

This replaces the reference's per-driver manifold factories
(e.g. obliquefactoryNTrans, src/primal/ManiSDP_unitdiag.m:173-198) and the
Manopt factories (manopt7.0/manopt/manifolds/{sphere,euclidean}/...).
Methods follow Manopt naming: inner/norm/proj/tangent/retr/transp/
zerovec/typicaldist/rand.
"""

from __future__ import annotations

from typing import Protocol

import jax.numpy as jnp


class Manifold(Protocol):
    """Static-method protocol; implementations are plain classes."""

    @staticmethod
    def inner(x, u, v): ...

    @staticmethod
    def norm(x, u): ...

    @staticmethod
    def proj(x, u): ...

    @staticmethod
    def retr(x, u): ...

    @staticmethod
    def zerovec(x): ...

    @staticmethod
    def typicaldist(p, n): ...


def frob_inner(x, u, v):
    """Ambient Frobenius metric; the point x is unused but kept for the
    uniform Manopt-style (x, u, v) signature."""
    return jnp.sum(u * v)


def frob_norm(x, u):
    return jnp.sqrt(jnp.sum(u * u))
