"""ManiSDP-JAX: a low-rank semidefinite-program solver in JAX.

A from-scratch JAX/XLA re-design of the capability surface of
wangjie212/ManiSDP-matlab: augmented-Lagrangian /
Riemannian-ADMM outer loops over a Burer-Monteiro factor Y with Riemannian
trust-region (truncated-CG) inner solves on oblique / sphere / Euclidean /
product manifolds, adaptive rank control via dual-matrix eigendecomposition,
and saddle-escape steps from negative eigenvectors.

Design (accelerator-first, not a port):
  - functional core: every inner solve is ONE jitted call built from
    ``lax.while_loop``; cost/grad/hess communicate through explicit ``aux``
    pytrees instead of MATLAB closure state (reference relies on Manopt's
    StoreDB call-order caching, see ManiSDP_unitdiag.m:152-171).
  - static shapes for dynamic rank: the factor Y lives in a padded
    (p_pad, n) buffer whose trailing rows are zero; rank changes rewrite
    rows, the shape only changes when the padding bucket grows.
  - factored everything: X = Y'Y is never materialized on the hot path;
    the sparse constraint operator acts on Y via gather/segment-sum.
  - float64 end-to-end by default (KKT tol 1e-8 requires it).
"""

import os

import jax

# tol=1e-8 KKT residuals are unreachable in f32; enable f64 before any
# array is created.
jax.config.update("jax_enable_x64", True)

# The optional f32 paths (inner_dtype="tcg32"/"mixed", the f32 LOBPCG
# pre-stage, f32 line-search trials) assume an f32 product keeps f32
# accuracy.  On a GPU an f32 matmul may run in TF32 (~3 decimal digits)
# unless a precision is asked for, so pin it.  f64 products are
# unaffected.
jax.config.update("jax_default_matmul_precision", "highest")

# Persistent compile cache: JAX reads JAX_COMPILATION_CACHE_DIR itself
# when it is set; otherwise keep the cache at a fixed path inside the
# checkout (the path is part of the cache key, so it must not move).
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update(
        "jax_compilation_cache_dir",
        os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), ".jax_cache"))
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

from .config import SolverOptions  # noqa: E402
from .solvers.maxcut import solve_maxcut_unitdiag  # noqa: E402
from .solvers.batch import solve_maxcut_batch  # noqa: E402
from .solvers.unitdiag import solve_unitdiag  # noqa: E402
from .solvers.unittrace import solve_unittrace  # noqa: E402
from .solvers.general import solve_sdp  # noqa: E402
from .solvers.dispatch import solve_sedumi  # noqa: E402
from .solvers.dual_unitdiag import solve_dual_unitdiag  # noqa: E402
from .solvers.dual_general import solve_dual_sdp  # noqa: E402
from .frontends.gset import load_gset_laplacian  # noqa: E402
from . import recipes  # noqa: E402

__all__ = [
    "SolverOptions",
    "recipes",
    "solve_maxcut_unitdiag",
    "solve_maxcut_batch",
    "solve_unitdiag",
    "solve_sedumi",
    "solve_unittrace",
    "solve_sdp",
    "solve_dual_unitdiag",
    "solve_dual_sdp",
    "load_gset_laplacian",
]

__version__ = "0.1.0"
