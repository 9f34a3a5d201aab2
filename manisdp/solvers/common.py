"""Shared outer-loop machinery for all ManiSDP-JAX drivers.

Every driver follows the same skeleton (SURVEY §2.1): per outer
iteration — optional saddle-escape line search -> RTR inner solve ->
residuals + multiplier update -> dual certificate -> rank truncation via
SVD of Y -> escape-direction append -> sigma adaptation -> stop /
slow-progress checks.  This module holds the pieces that are identical
across drivers.

Rank policy under static shapes: the factor is a (p_pad, n) buffer with
zero padding rows, p_pad = the active rank p rounded up to a bucket
(multiple of ``p_bucket``).  Jitted functions are cached per p_pad, so
XLA recompiles only when the bucket changes.  Rank edits (truncate /
append escape rows) happen on host in numpy — they are O(p*n) once per
outer iteration, off the hot path.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SolverOptions


@dataclasses.dataclass
class SDPResult:
    """Solver output mirroring the reference's ``[X, obj, data]``."""
    X: Any                     # primal matrix (np.ndarray) or factor blocks
    obj: float
    Y: np.ndarray              # final factor (active rows only)
    y: Optional[np.ndarray] = None     # multipliers
    S: Optional[np.ndarray] = None     # dual slack matrix (dense, if formed)
    z: Optional[np.ndarray] = None
    gap: float = np.nan
    pinf: float = np.nan
    dinf: float = np.nan
    eta: float = np.nan        # max KKT residual
    gradnorm: float = np.nan
    time: float = 0.0
    status: int = 0            # 0 optimal, 1 iter max, 2 slow progress
    iterations: int = 0
    fac_size: Optional[list] = None
    rtr_iters: int = 0         # total accepted/rejected TR iterations
    hess_calls: int = 0        # total tCG inner iterations (Hv products)
    precision_fallbacks: int = 0   # tcg32 -> f64 inner demotions
    history: Optional[list] = None
    timers: Optional[dict] = None  # per-phase seconds: rtr/cert/rank/stats
    # final penalty + TR-budget tier: pass back as sigma0= / tier on
    # resume so a checkpointed run continues the exact trajectory
    sigma: Optional[float] = None
    tier: int = 0


class PhaseTimers:
    """Cheap wall-clock accounting of the outer loop's phases."""

    def __init__(self):
        self.t = {}
        self._snap = {}

    def add(self, phase: str, dt: float):
        self.t[phase] = self.t.get(phase, 0.0) + dt

    def log_delta(self, verbose):
        """verbose == 2: print per-phase seconds since the last call
        (per-iteration profile; drivers call this after log_iter)."""
        if verbose != 2:
            return
        d = {k: v - self._snap.get(k, 0.0) for k, v in self.t.items()}
        self._snap = dict(self.t)
        print("  phases: " + ", ".join(f"{k}:{v:.2f}s"
                                       for k, v in d.items()), flush=True)

    def timed(self, phase: str):
        timers = self

        class _Ctx:
            def __enter__(self):
                self._t0 = time.time()

            def __exit__(self, *a):
                timers.add(phase, time.time() - self._t0)

        return _Ctx()


def bucketed(p: int, bucket: int) -> int:
    return ((p + bucket - 1) // bucket) * bucket


def pad_rows(Y: np.ndarray, p_pad: int) -> np.ndarray:
    """Zero-pad a (p, n) factor to (p_pad, n)."""
    p, n = Y.shape
    if p == p_pad:
        return np.ascontiguousarray(Y)
    out = np.zeros((p_pad, n), dtype=Y.dtype)
    out[:p] = Y
    return out


def gram_svd(Y_dev, p: int):
    """Singular values / left singular vectors of the active factor.

    Computes the tiny p_pad x p_pad Gram on device, eigendecomposes on
    host.  Returns (e, U): singular values descending (length p) and the
    matching left singular vectors (p_pad, p) so that the truncated
    factor is U[:, :r].T @ Y  (== diag(e_r) V_r' of the reference,
    ManiSDP_unitdiag.m:72,94).
    """
    G = np.asarray(jax.device_get(Y_dev @ Y_dev.T))
    w, V = np.linalg.eigh(G)            # ascending
    w = np.maximum(w, 0.0)
    order = np.argsort(w)[::-1][:p]
    return np.sqrt(w[order]), V[:, order]


class RankController:
    """Rank truncation + escape append for single-block drivers.

    ``layout`` is always (p, n); oblique/sphere renormalization is the
    caller's responsibility via ``renormalize``.
    """

    def __init__(self, theta: float, delta: int, alpha: float,
                 nne_floor: bool, bucket: int):
        self.theta = theta
        self.delta = delta
        self.alpha = alpha
        self.nne_floor = nne_floor   # max(..., 1) floor, oblique drivers
        self.bucket = bucket

    def truncation(self, Y_dev, p: int):
        """Detect over-parameterized rank; return (r, e, U)."""
        e, U = gram_svd(Y_dev, p)
        r = int(np.sum(e >= self.theta * e[0]))
        return max(r, 1), e, U

    def num_escape(self, num_neg: int) -> int:
        nne = min(int(num_neg), self.delta)
        if self.nne_floor:
            nne = max(nne, 1)
        return nne


def sigma_update(sigma: float, pinf: float, gradnorm: float,
                 opt: SolverOptions) -> float:
    """Self-adaptive penalty schedule (ManiSDP_unitdiag.m:108-112)."""
    if pinf < opt.tau1 * gradnorm:
        return max(sigma / opt.gama, opt.sigma_min)
    elif pinf > opt.tau2 * gradnorm:
        return min(sigma * opt.gama, opt.sigma_max)
    return sigma


class SlowProgress:
    """Every ``period`` iterations: if none of the tracked residuals
    improved since the previous checkpoint (and iter > warmup), flag
    status 2 (ManiSDP_unitdiag.m:82-92)."""

    def __init__(self, period: int, warmup: int):
        self.period = period
        self.warmup = warmup
        self.prev: Optional[tuple] = None

    def check(self, it: int, *residuals: float) -> bool:
        if it % self.period != 0:
            return False
        if it > self.warmup and self.prev is not None and \
                all(r > r0 for r, r0 in zip(residuals, self.prev)):
            return True
        self.prev = tuple(residuals)
        return False


def make_line_search(cost_fn: Callable, renorm: Callable,
                     max_extra: int = 45, wrap: Callable = jax.jit,
                     ls_dtype=None):
    """Backtracking saddle-escape line search (ManiSDP_unitdiag.m:138-150).

    alpha starts at 1, shrinks by 0.8 up to 15 times, accepts when the
    AL cost drops by at least 1e-3 — reference-exact in that regime.

    The reference then force-accepts the 15-times-shrunk step even if it
    INCREASES the cost; near convergence (|lambda_min(S)| tiny) the
    available decrease is far below 1e-3, so that forced accept injects
    an O(0.035)-sized perturbation every outer iteration, re-exciting
    the gradient and freezing the sigma controller (observed limit cycle
    on the Lovasz-theta workload).  Here we instead keep shrinking for
    up to ``max_extra`` more steps until the cost strictly decreases —
    the escape direction is second-order descent whenever lambda_min(S)
    < 0, so a small enough alpha always exists; the accepted step then
    never loses ground.  Runs as one jitted while_loop.

    ``cost_fn(Y, params) -> f``; ``renorm`` maps an ambient point back to
    the manifold (column-normalize / F-normalize / identity).
    """
    i_max = 15 + max_extra
    # ls_dtype="float32": evaluate the FIRST-15 trial COSTS in f32 (the
    # accepted point stays f64).  That phase's accept test compares
    # against an absolute 1e-3 decrease (ManiSDP_unitdiag.m:144) —
    # orders of magnitude above f32 noise for these cost scales — while
    # a full f64 AL cost eval pays the sparse-operator pipeline
    # (15 evals per outer iteration).  The extended strict-decrease tail
    # (i > 15) runs near convergence where the genuine decrease is
    # BELOW f32 noise (~1e-7*|f|), so its comparisons — and the final
    # keep/stay-put guard — always use full-precision cost evals
    # (an f32 tail can accept cost-increasing steps,
    # re-introducing the perturbation limit cycle it exists to
    # prevent).  The tail engages only when the 15-step phase failed to
    # find a 1e-3 decrease, so its f64 evals are off the hot path.
    ls_dt = jnp.dtype(ls_dtype) if ls_dtype else None
    # Snapshot the debug switch at closure-BUILD time — the
    # traced branch is baked into cached programs, so reading os.environ
    # inside the traced body made later flips silently ineffective.
    # MANISDP_LS_TAIL must be set before the first solve in a process.
    import os as _os
    _noisy_tail = _os.environ.get("MANISDP_LS_TAIL") == "noisy32"

    def line_search(Y, U, params):
        if ls_dt is not None:
            cast = lambda x: x.astype(ls_dt) \
                if hasattr(x, "dtype") and \
                jnp.issubdtype(x.dtype, jnp.floating) else x
            params_c = jax.tree_util.tree_map(cast, params)
            f_of = lambda P: cost_fn(P.astype(ls_dt),
                                     params_c).astype(jnp.float64)
        else:
            f_of = lambda P: cost_fn(P, params)
        f_full = lambda P: cost_fn(P, params)
        f0 = f_of(Y)

        def trial(a):
            nY = renorm(Y + a * U)
            return nY, f_of(nY)

        nY1, f1 = trial(jnp.float64(1.0))

        def cond(c):
            alpha, i, _, f = c
            return (i <= 15) & (f - f0 > -1e-3)

        def body(c):
            alpha, i, _, _ = c
            alpha = 0.8 * alpha
            nY, f = trial(alpha)
            return (alpha, i + 1, nY, f)

        alpha, i, nY, f = jax.lax.while_loop(
            cond, body, (jnp.float64(1.0), jnp.int32(1), nY1, f1))

        if _noisy_tail:
            # debugging switch: the pre-round-4 tail (strict decrease
            # in the line-search eval dtype, f32 noise and all)
            def cond_o(c):
                alpha, i, _, f = c
                return (i <= i_max) & (f >= f0)

            def body_o(c):
                alpha, i, _, _ = c
                alpha = 0.8 * alpha
                nY2, f2 = trial(alpha)
                return (alpha, i + 1, nY2, f2)

            _, _, nYo, fo = jax.lax.while_loop(
                cond_o, body_o, (alpha, i, nY, f))
            return jax.tree_util.tree_map(
                lambda a, b2: jnp.where(fo < f0, a, b2), nYo, Y)

        def tail(args):
            alpha, i, nY = args
            f0d = f_full(Y)
            fd = f_full(nY)

            def cond2(c):
                alpha, i, _, f = c
                return (i <= i_max) & (f >= f0d)

            def body2(c):
                alpha, i, _, _ = c
                alpha = 0.8 * alpha
                nY = renorm(Y + alpha * U)
                return (alpha, i + 1, nY, f_full(nY))

            _, _, nY, f = jax.lax.while_loop(
                cond2, body2, (alpha, i, nY, fd))
            # if even the smallest step failed to decrease, stay put
            return jax.tree_util.tree_map(
                lambda a, b: jnp.where(f < f0d, a, b), nY, Y)

        return jax.lax.cond(f - f0 <= -1e-3,
                            lambda args: args[2], tail, (alpha, i, nY))

    return wrap(line_search)


class JitCache:
    """Per-(p_pad, tag) cache of compiled solver functions."""

    def __init__(self, factory: Callable[[int], Any]):
        self.factory = factory
        self._cache: Dict[int, Any] = {}

    def __call__(self, p_pad: int):
        if p_pad not in self._cache:
            self._cache[p_pad] = self.factory(p_pad)
        return self._cache[p_pad]


def log_iter(verbose: bool, it: int, obj: float, *, gap=None, pinf=None,
             dinf: float, gradnorm=None, r=None, p: int, sigma=None,
             t0: float):
    if not verbose:
        return
    parts = [f"Iter {it}, obj:{obj:0.8f}"]
    if gap is not None:
        parts.append(f"gap:{gap:0.1e}")
    if pinf is not None:
        parts.append(f"pinf:{pinf:0.1e}")
    parts.append(f"dinf:{dinf:0.1e}")
    if gradnorm is not None:
        parts.append(f"gradnorm:{gradnorm:0.1e}")
    if r is not None:
        parts.append(f"r:{r}")
    parts.append(f"p:{p}")
    if sigma is not None:
        parts.append(f"sigma:{sigma:0.3f}")
    parts.append(f"time:{time.time() - t0:0.2f}s")
    print(", ".join(parts), flush=True)
