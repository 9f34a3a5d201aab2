"""Row-layout LOBPCG certificates of the dual matrix.

Both solvers keep every (block, n) array in ROW layout, the layout of
the tCG hot loop: the matvec is ``rows @ S`` (== (S V)' for symmetric
S), which every operator already provides as ``matmat_pattern`` /
``SymCOO.matmat``.

  - ``RowCertSolver`` does the 3b x 3b Rayleigh-Ritz on HOST numpy
    each iteration (no block-size limit) and can run the bulk of the
    iterations in f32, switching to f64 when residuals reach the f32
    floor; the host RR is always f64.
  - ``DeviceCertSolver`` runs the whole eigensolve on the device, one
    dispatch per certificate.

Soundness contract (same as ops/eigs.py): the reported lam_min is the
f64 residual-backed lower bound ritz_0 - ||r_0||, so an unconverged or
f32-polluted solve can only make dinf CONSERVATIVE, never falsely
certify optimality.  Reference semantics being replaced: the full
``eig(S, 'vector')`` per outer iteration (ManiSDP_onlyunitdiag.m:50,
ManiSDP_unitdiag.m:68, ManiDSDP_unitdiag.m:84).

The solver object jits its device phases ONCE; per-outer-iteration
operator data (dual-matrix values, shifts) flows through a ``ctx``
pytree argument, so outer iterations reuse the compiled programs
(recompiles happen only when the block size b changes with the rank).
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .eigs import CertResult


def _host_rr(G: np.ndarray, H: np.ndarray, drop_tol: float):
    """Generalized Rayleigh-Ritz on host: eigenpairs of H restricted to
    the (whitened) span with Gram G.  Returns (theta ascending,
    G-orthonormal coefficients C with C' G C = I)."""
    G = (G + G.T) * 0.5
    H = (H + H.T) * 0.5
    w, V = np.linalg.eigh(G)
    keep = w > drop_tol * max(w[-1], 1e-300)
    if not np.any(keep):
        keep = w == w[-1]
    W = V[:, keep] / np.sqrt(w[keep])
    Hs = W.T @ H @ W
    th, U = np.linalg.eigh((Hs + Hs.T) * 0.5)
    return th, W @ U


def _nrm(x, axis=None, keepdims=False):
    """2-norm scaled by max|x| so that it neither underflows nor
    overflows anywhere in the f64 range (squares of 1e-200 or 1e200
    would)."""
    m = jnp.max(jnp.abs(x), axis=axis, keepdims=True)
    m = jnp.where(m > 0, m, 1.0)
    r = m * jnp.sqrt(jnp.sum(jnp.square(x / m), axis=axis, keepdims=True))
    return r if keepdims else (jnp.squeeze(r, axis) if axis is not None
                               else r.reshape(()))


class RowCertSolver:
    """Reusable row-layout LOBPCG eigensolver.

    ``matvec_rows(V, ctx) -> V @ S`` where ``ctx`` is an arbitrary
    pytree of per-call operator data (e.g. dual-matrix values on the
    pattern and the diagonal shift).  ``matvec32_rows``: the same in
    float32 (receives ``ctx`` cast to f32); enables the f32 bulk stage.
    """

    def __init__(self, matvec_rows: Callable, n: int,
                 matvec32_rows: Optional[Callable] = None):
        self.n = n
        self._mv64 = jax.jit(matvec_rows)
        self._expand64, self._contract64 = self._make_steps(matvec_rows)
        self._have32 = matvec32_rows is not None
        if self._have32:
            self._expand32, self._contract32 = \
                self._make_steps(matvec32_rows)
        self._lanczos_jit = self._make_lanczos(matvec_rows, n)
        self._cast32 = jax.jit(lambda t: jax.tree_util.tree_map(
            lambda x: x.astype(jnp.float32)
            if jnp.issubdtype(x.dtype, jnp.floating) else x, t))

    # -- jitted device phases ---------------------------------------------
    @staticmethod
    def _make_steps(matvec_rows):
        @jax.jit
        def expand(X, AX, P, AP, theta, ctx):
            R = AX - theta[:, None] * X
            rn = jnp.sqrt(jnp.sum(R * R, axis=1))
            R = R / jnp.maximum(rn, 1e-300)[:, None]
            AR = matvec_rows(R, ctx)
            Z = jnp.concatenate([X, R, P], axis=0)
            AZ = jnp.concatenate([AX, AR, AP], axis=0)
            return Z, AZ, Z @ Z.T, Z @ AZ.T, rn

        @jax.jit
        def contract(Z, AZ, Cx, Cp):
            return Cx @ Z, Cx @ AZ, Cp @ Z, Cp @ AZ

        return expand, contract

    @staticmethod
    def _make_lanczos(matvec_rows, n: int, iters: int = 32):
        """Spectral-interval estimate via Lanczos on (1, n) ROW
        vectors; the final 32x32 tridiagonal eigh runs on device."""

        @jax.jit
        def run(ctx, key):
            v = jax.random.normal(key, (1, n), dtype=jnp.float64)
            v = v / jnp.linalg.norm(v)

            def body(carry, _):
                v_prev, v_cur, beta = carry
                w = matvec_rows(v_cur, ctx) - beta * v_prev
                alpha = jnp.vdot(v_cur, w)
                w = w - alpha * v_cur
                beta_new = jnp.linalg.norm(w)
                v_next = w / jnp.maximum(beta_new, 1e-300)
                return (v_cur, v_next, beta_new), (alpha, beta_new)

            (_, _, _), (alphas, betas) = jax.lax.scan(
                body, (jnp.zeros_like(v), v, jnp.float64(0.0)), None,
                length=iters)
            alphas = alphas.reshape(-1)
            betas = betas.reshape(-1)[:-1]
            T = jnp.diag(alphas) + jnp.diag(betas, 1) + \
                jnp.diag(betas, -1)
            ritz = jnp.linalg.eigvalsh(T)
            slack = jnp.abs(betas[-1])
            return ritz[0] - slack, ritz[-1] + slack

        return run

    def bounds(self, ctx, key):
        lo, hi = self._lanczos_jit(ctx, key)
        return float(lo), float(hi)

    # -- main solve --------------------------------------------------------
    def solve(self, ctx, key, k: int, X0=None, deflate=None,
              maxiter: int = 200, tol: float = 1e-9,
              use32: Optional[bool] = None, switch_tol: float = 1e-5,
              lam_hint=None, block_cap: Optional[int] = None) -> CertResult:
        """``block_cap``: total working-block budget (k + deflation
        augmentation), default 24.  A caller may raise it (e.g.
        96-128) to certify THROUGH a near-null cluster wider than the
        default augmentation — the accuracy-deciding retry of the
        maxcut driver does exactly that."""
        n = self.n
        if use32 is None:
            use32 = self._have32
        use32 = use32 and self._have32
        key_l, key_x, key_q = jax.random.split(key, 3)

        # block assembly (rows): wanted k + deflation augmentation
        blocks = []
        if X0 is not None:
            X0 = jnp.asarray(X0, dtype=jnp.float64)
            if X0.shape[0] == n and (X0.ndim == 1 or X0.shape[1] != n):
                X0 = X0.T
            blocks.append(X0[:k])
        else:
            blocks.append(
                jax.random.normal(key_x, (k, n), dtype=jnp.float64))
        b = blocks[0].shape[0]
        cap = 24 if block_cap is None else int(block_cap)
        aug_budget = max(min((n - 1) // 5 - b, cap - b), 0)
        if deflate is not None and aug_budget > 0:
            Yd = jnp.asarray(deflate, dtype=jnp.float64)
            p_d = min(Yd.shape[0], aug_budget)
            G = Yd @ Yd.T
            w, V = jnp.linalg.eigh(G)
            w = w[::-1][:p_d]
            V = V[:, ::-1][:, :p_d]
            good = w > 1e-12 * jnp.maximum(w[0], 1e-300)
            scale_q = 1.0 / jnp.sqrt(jnp.maximum(w, 1e-300))
            Q = (V * scale_q[None, :]).T @ Yd
            rnd = jax.random.normal(key_q, (p_d, n), dtype=jnp.float64)
            blocks.append(jnp.where(good[:, None], Q, rnd))
        X = jnp.concatenate(blocks, axis=0)
        b = X.shape[0]

        if lam_hint is not None:
            lo, hi = lam_hint
        else:
            lo, hi = self.bounds(ctx, key_l)
        scale = max(float(jnp.maximum(jnp.abs(lo), jnp.abs(hi))), 1e-30)

        # initial RR on [X] to orthonormalize and seed theta
        AX = self._mv64(X, ctx)
        Gx = np.asarray(jax.device_get(X @ X.T))
        Hx = np.asarray(jax.device_get(X @ AX.T))
        th, Cd_h = self._host_pad_rr(Gx, Hx, b, 1e-12)
        Cd = jnp.asarray(Cd_h)
        X, AX = Cd @ X, Cd @ AX
        theta = jnp.asarray(th)
        P = jnp.zeros_like(X)
        AP = jnp.zeros_like(AX)

        stages = []
        if use32:
            stages.append((self._expand32, self._contract32, jnp.float32,
                           max(tol, switch_tol), 1e-6,
                           self._cast32(ctx)))
        stages.append((self._expand64, self._contract64, jnp.float64,
                       tol, 1e-12, ctx))

        iters_done = 0
        for si, (expand, contract, dt, stage_tol, drop_tol, sctx) in \
                enumerate(stages):
            if iters_done >= maxiter:
                break
            X, P = X.astype(dt), P.astype(dt)
            if si > 0:
                # entering f64 from f32: carried A-products hold f32
                # error; recompute so the residuals are honest
                AX, AP = self._mv64(X, ctx), self._mv64(P, ctx)
            else:
                AX, AP = AX.astype(dt), AP.astype(dt)
            theta = theta.astype(dt)
            while iters_done < maxiter:
                Z, AZ, G_d, H_d, rn = expand(X, AX, P, AP, theta, sctx)
                rn_h = np.asarray(jax.device_get(rn))
                if np.max(rn_h[:k]) < stage_tol * scale:
                    break
                G = np.asarray(jax.device_get(G_d), dtype=np.float64)
                H = np.asarray(jax.device_get(H_d), dtype=np.float64)
                th, C = _host_rr(G, H, drop_tol)
                nb = min(b, C.shape[1])
                Cx = np.zeros((b, 3 * b))
                Cx[:nb] = C[:, :nb].T
                # P-direction: R/P components of the new X (classic
                # three-term recurrence), normalized in the G-metric
                Cp = Cx.copy()
                Cp[:, :b] = 0.0
                pn = np.sqrt(np.maximum(
                    np.einsum("ij,jk,ik->i", Cp, G, Cp), 1e-300))
                Cp = Cp / pn[:, None]
                X, AX, P, AP = contract(
                    Z, AZ, jnp.asarray(Cx, dtype=dt),
                    jnp.asarray(Cp, dtype=dt))
                theta = jnp.asarray(np.pad(
                    th[:b], (0, max(0, b - th.shape[0])),
                    constant_values=th[-1] if th.size else 0.0), dtype=dt)
                iters_done += 1

        # final f64 residual-backed bounds
        X = X.astype(jnp.float64)
        AX = self._mv64(X, ctx)
        Gx = np.asarray(jax.device_get(X @ X.T))
        Hx = np.asarray(jax.device_get(X @ AX.T))
        th, Cd_h = self._host_pad_rr(Gx, Hx, b, 1e-12)
        Cd = jnp.asarray(Cd_h)
        X = Cd @ X
        AX = Cd @ AX
        theta_f = jnp.asarray(th)
        Rf = AX - theta_f[:, None] * X
        resid = jnp.sqrt(jnp.sum(Rf * Rf, axis=1))
        s_lower = theta_f - resid

        return CertResult(
            lam_min=s_lower[0], lam_max=jnp.asarray(hi),
            num_neg=jnp.sum(theta_f < 0),
            neg_vecs=X[:k].T,                # (n, k) — caller contract
            neg_vals=theta_f[:k])

    # -- helpers -----------------------------------------------------------
    @staticmethod
    def _host_pad_rr(G, H, b, drop_tol):
        """RR + pad coefficients/values back to the full block size."""
        th, C = _host_rr(G, H, drop_tol)
        nb = min(b, C.shape[1])
        Cd = np.zeros((b, b))
        Cd[:nb] = C[:, :nb].T
        th_p = np.pad(th[:nb], (0, b - nb),
                      constant_values=th[-1] if th.size else 0.0)
        return th_p, Cd

    def _lanczos_run(self, ctx, key, iters: int = 32):
        n = self.n
        mv = self._mv64

        @jax.jit
        def run(ctx, key):
            v = jax.random.normal(key, (1, n), dtype=jnp.float64)
            v = v / jnp.linalg.norm(v)

            def body(carry, _):
                v_prev, v_cur, beta = carry
                w = mv(v_cur, ctx) - beta * v_prev
                alpha = jnp.vdot(v_cur, w)
                w = w - alpha * v_cur
                beta_new = jnp.linalg.norm(w)
                v_next = w / jnp.maximum(beta_new, 1e-300)
                return (v_cur, v_next, beta_new), (alpha, beta_new)

            (_, _, _), (alphas, betas) = jax.lax.scan(
                body, (jnp.zeros_like(v), v, jnp.float64(0.0)), None,
                length=iters)
            alphas = alphas.reshape(-1)
            betas = betas.reshape(-1)[:-1]
            T = jnp.diag(alphas) + jnp.diag(betas, 1) + jnp.diag(betas, -1)
            ritz = jnp.linalg.eigvalsh(T)
            slack = jnp.abs(betas[-1])
            return ritz[0] - slack, ritz[-1] + slack

        if not hasattr(self, "_lanczos_jit"):
            self._lanczos_jit = run
        lo, hi = self._lanczos_jit(ctx, key)
        return float(lo), float(hi)


class DeviceCertSolver:
    """Fully device-resident row-layout LOBPCG certificate.

    The RowCertSolver above pays ~3 host round-trips per LOBPCG
    iteration (residual check + Gram fetches for the host
    Rayleigh-Ritz).  This solver moves the ENTIRE eigensolve onto the
    device:

      - the spectral-interval Lanczos pass,
      - the deflation-block whitening (eigh of the p_pad x p_pad Gram),
      - the LOBPCG loop as a ``lax.while_loop`` whose Rayleigh-Ritz runs
        on-device (two 3b x 3b f64 eighs per iteration),
      - the final honest recompute of A X and the residual-backed
        bounds.

    One dispatch + one small fetch per certificate call.  ``maxiter``
    and ``tol`` are runtime scalars, so adaptive budgets do not
    recompile.  Soundness contract: lam_min is an f64 residual-backed
    lower bound — ritz_0 - ||r_0|| (linear), sharpened to the
    Kato-Temple quadratic ritz_0 - ||r_0||^2/gap ONLY when another Ritz
    pair's certified interval witnesses the gap (see ``finish``); a
    stagnated solve always falls back to the linear bound.

    Reference semantics replaced: the per-outer-iteration full
    ``eig(S, 'vector')`` (ManiSDP_onlyunitdiag.m:50, ManiSDP.m:66,
    ManiDSDP_unitdiag.m:84).
    """

    BIG = 1e30          # dropped basis directions' Ritz value / |H|
    TINY = float(np.finfo(np.float64).tiny)   # IEEE-f64 norm floor

    def __init__(self, matvec_rows: Callable, n: int, k: int,
                 deflate_rows: int = 0, aug_cap: Optional[int] = None,
                 lanczos_iters: int = 32):
        # block b = k + aug <= max(k, aug_cap); the on-device
        # Rayleigh-Ritz eighs are 3b x 3b
        if aug_cap is None:
            aug_cap = 24
        self.n = n
        self.k = k
        self.dr = deflate_rows
        # deflation augmentation: Y's strong directions join the block so
        # Rayleigh-Ritz resolves the near-null cluster internally.  The
        # block is FIXED at b = k + aug (short Y is padded with random
        # rows), so one compiled program serves every outer iteration.
        aug = max(min((n - 1) // 5, aug_cap) - k, 0) if deflate_rows else 0
        self.aug = aug
        self.b = k + aug
        if 3 * self.b >= n:
            raise ValueError(
                f"DeviceCertSolver needs n > 3*(k+aug) = {3 * self.b}; "
                f"got n = {n} (use the dense eigh certificate instead)")
        self._iters = lanczos_iters
        self._mv = matvec_rows
        self._run = self._build(matvec_rows)

    # -- device Rayleigh-Ritz ---------------------------------------------
    @staticmethod
    def _rr(G, H, drop_tol, nkeep):
        """Eigenpairs of H restricted to the span with Gram G, on
        device.  Dropped (near-dependent) directions get Ritz value BIG
        so they sort past the wanted bottom block; their coefficient
        columns are zero — matching the host _host_pad_rr semantics."""
        G = (G + G.T) * 0.5
        H = (H + H.T) * 0.5
        w, V = jnp.linalg.eigh(G)
        wmax = jnp.maximum(w[-1], DeviceCertSolver.TINY)
        keep = w > drop_tol * wmax
        s = jnp.where(keep,
                      1.0 / jnp.sqrt(jnp.maximum(w, DeviceCertSolver.TINY)),
                      0.0)
        W = V * s[None, :]
        Hs = W.T @ H @ W
        Hs = (Hs + Hs.T) * 0.5
        # dropped directions sort past the kept ones at any scale
        big = DeviceCertSolver.BIG * jnp.maximum(jnp.max(jnp.abs(Hs)),
                                                 DeviceCertSolver.TINY)
        Hs = Hs + jnp.diag(jnp.where(keep, 0.0, big))
        th, U = jnp.linalg.eigh(Hs)
        C = W @ U
        return th[:nkeep], C[:, :nkeep]

    def _build(self, mv):
        n, k, b, aug, dr = self.n, self.k, self.b, self.aug, self.dr
        iters = self._iters
        TINY = DeviceCertSolver.TINY

        # prep -> loop -> finish run as ONE jitted program: on an H100
        # it compiled in 5.2 s against 8.3 s for three separate jits,
        # with the same warm time (0.18 s per call at n = 10^4).

        def prep(ctx, Ypad, X0, key, tol):
            key_l, key_q = jax.random.split(key)
            # -- Lanczos spectral-interval bounds (row layout) --
            v = jax.random.normal(key_l, (1, n), dtype=jnp.float64)
            v = v / _nrm(v)

            def lan_body(carry, _):
                v_prev, v_cur, beta = carry
                w = mv(v_cur, ctx) - beta * v_prev
                alpha = jnp.vdot(v_cur, w)
                w = w - alpha * v_cur
                beta_new = _nrm(w)
                v_next = w / jnp.maximum(beta_new, TINY)
                return (v_cur, v_next, beta_new), (alpha, beta_new)

            (_, _, _), (alphas, betas) = jax.lax.scan(
                lan_body, (jnp.zeros_like(v), v, jnp.float64(0.0)), None,
                length=iters)
            alphas = alphas.reshape(-1)
            betas = betas.reshape(-1)[:-1]
            T = jnp.diag(alphas) + jnp.diag(betas, 1) + jnp.diag(betas, -1)
            ritz = jnp.linalg.eigvalsh(T)
            slack = jnp.abs(betas[-1])
            lo, hi = ritz[0] - slack, ritz[-1] + slack
            scale = jnp.maximum(
                jnp.maximum(jnp.abs(lo), jnp.abs(hi)), TINY)

            # -- block assembly: X0 rows + whitened deflation rows --
            blocks = [X0]
            if dr:
                t = min(aug, dr)
                G = Ypad @ Ypad.T
                w, V = jnp.linalg.eigh(G)
                w_top = w[::-1][:t]
                V_top = V[:, ::-1][:, :t]
                good = w_top > 1e-12 * jnp.maximum(w_top[0], TINY)
                sc = jnp.where(good, 1.0 / jnp.sqrt(jnp.maximum(
                    w_top, TINY)), 0.0)
                Q = (V_top * sc[None, :]).T @ Ypad
                rnd = jax.random.normal(key_q, (aug, n),
                                        dtype=jnp.float64)
                blocks.append(jnp.where(good[:, None], Q, rnd[:t]))
                if aug > t:
                    blocks.append(rnd[t:])
            X = jnp.concatenate(blocks, axis=0)           # (b, n)
            X = X / jnp.maximum(
                _nrm(X, axis=1, keepdims=True), TINY)

            # -- Rayleigh-quotient seeding (no RR here: the loop's first
            #    Rayleigh-Ritz orthonormalizes the block anyway) --
            AX = mv(X, ctx)
            theta = jnp.sum(X * AX, axis=1)
            rn = _nrm(AX - theta[:, None] * X, axis=1)
            return X, AX, theta, rn, lo, hi, scale

        def loop(ctx, X, AX, theta, rn, scale, maxiter, tol):
            P = jnp.zeros_like(X)
            AP = jnp.zeros_like(AX)

            def cond(s):
                X, AX, P, AP, theta, rn, j = s
                return (j < maxiter) & (jnp.max(rn[:k]) >= tol * scale)

            def body(s):
                X, AX, P, AP, theta, rn, j = s
                R = AX - theta[:, None] * X
                R = R / jnp.maximum(rn, TINY)[:, None]
                AR = mv(R, ctx)
                Z = jnp.concatenate([X, R, P], axis=0)
                AZ = jnp.concatenate([AX, AR, AP], axis=0)
                G = Z @ Z.T
                H = Z @ AZ.T
                th, C = DeviceCertSolver._rr(G, H, 1e-12, b)
                Cx = C.T                                   # (b, 3b)
                Cp = Cx * jnp.concatenate(
                    [jnp.zeros((b, b)), jnp.ones((b, 2 * b))], axis=1)
                pn = jnp.sqrt(jnp.maximum(
                    jnp.sum((Cp @ G) * Cp, axis=1), TINY))
                Cp = Cp / pn[:, None]
                Xn, AXn = Cx @ Z, Cx @ AZ
                Pn, APn = Cp @ Z, Cp @ AZ
                rn_n = _nrm(AXn - th[:, None] * Xn, axis=1)
                # stability guard: once residuals grind past the f64
                # floor the whitened basis can go non-finite; keep the
                # LAST GOOD block and stop.
                # Arithmetic masking (jnp.where on a scalar predicate
                # is avoided here purely for lowering simplicity).
                ok = jnp.isfinite(jnp.sum(Xn) + jnp.sum(th) +
                                  jnp.sum(rn_n))
                m = ok.astype(Xn.dtype)
                nm = 1.0 - m
                z = lambda a: jnp.nan_to_num(a, nan=0.0, posinf=0.0,
                                             neginf=0.0)
                pick = lambda new, old: m * z(new) + nm * old
                oki = ok.astype(j.dtype)
                return (pick(Xn, X), pick(AXn, AX), pick(Pn, P),
                        pick(APn, AP), pick(th, theta), pick(rn_n, rn),
                        oki * (j + 1) + (1 - oki) * maxiter)

            X, AX, P, AP, theta, rn, j = jax.lax.while_loop(
                cond, body, (X, AX, P, AP, theta, rn, jnp.int32(0)))
            return X, j

        def finish(ctx, X, hi):
            # honest epilogue: recompute A X (the loop's AX is a linear
            # combination of earlier products and carries drift) and
            # derive the reported bounds from exact f64 residuals.
            #
            # TWO accuracy corrections per Ritz pair (th_i, r_i):
            #   linear   : |lambda - th_i| <= r_i          (always valid)
            #   quadratic: r_i^2 / gap_i  (Kato-Temple), applied ONLY
            #              when another Ritz pair j WITNESSES the gap:
            #              its certified interval lies strictly above
            #              this one (th_j - r_j > th_i + r_i), and
            #              gap_i = min over such j of (th_j - r_j) - th_i.
            # The linear bound alone is useless on CLUSTERED spectra: at
            # a maxcut optimum S has a p-fold near-null cluster whose
            # internal spread floors every per-vector residual (measured
            # on G67: ritz0 converges to -8e-12 while resid plateaus at
            # ~1e-6, so the linear bound stalls dinf at ~1e-7 and the
            # solve can never certify 1e-8).  Because the block covers
            # the whole cluster (b = k + aug >= cluster size), the first
            # ABOVE-cluster pair supplies a certified gap witness and the
            # quadratic correction engages; a stagnated solve whose
            # neighbors are equally unconverged gets NO witness and
            # falls back to the linear bound (a block-spread gap
            # estimate could exceed the true gap and turn the bound
            # unsound).  Remaining assumption,
            # standard for converged Krylov blocks: no eigenvalue hides
            # between th_i and its witness without any Ritz
            # representation.  The reference's dinf is itself an
            # UNCERTIFIED floating-point eig value
            # (ManiSDP_onlyunitdiag.m:50-51); this is strictly more
            # careful than that semantics.
            AXf = mv(X, ctx)
            th_f, C_f = DeviceCertSolver._rr(X @ X.T, X @ AXf.T,
                                             1e-12, b)
            X = C_f.T @ X
            AXf = C_f.T @ AXf
            Rf = AXf - th_f[:, None] * X
            resid = _nrm(Rf, axis=1)
            up = th_f - resid                    # certified lower ends
            cand = jnp.where(up[None, :] > (th_f + resid)[:, None],
                             up[None, :], jnp.inf)   # gap witnesses
            wit = jnp.min(cand, axis=1)          # per-i closest witness
            gap_i = jnp.maximum(wit - th_f, DeviceCertSolver.TINY)
            # resid * (resid / gap) rather than resid**2 / gap: the
            # square underflows for spectra near the f64 range floor
            corr = jnp.where(jnp.isfinite(wit),
                             jnp.minimum(resid, resid * (resid / gap_i)),
                             resid)
            s_lower = th_f - corr
            # escape-direction count: only MEANINGFULLY negative Ritz
            # values (th + corr < 0).  Counting raw sign noise (the
            # reference's sum(dS < 0) on exact eigenvalues) makes the
            # rank controller append junk escape directions forever
            # once th_0 fluctuates around 0 at the optimum.
            num_neg = jnp.sum(th_f + corr < 0)
            return (s_lower[0], hi, num_neg, X[:k], th_f[:k],
                    jnp.max(resid[:k]))

        def run(ctx, Ypad, X0, key, tol, maxiter):
            X, AX, theta, rn, lo, hi, scale = prep(ctx, Ypad, X0, key, tol)
            X, j = loop(ctx, X, AX, theta, rn, scale, maxiter, tol)
            return finish(ctx, X, hi) + (j, scale, lo)

        return jax.jit(run)

    def solve(self, ctx, key, X0=None, Ypad=None,
              maxiter: int = 200, tol: float = 1e-10) -> CertResult:
        n, k = self.n, self.k
        if self.dr:
            if Ypad is None:
                raise ValueError("solver built with deflate_rows needs Ypad")
            if Ypad.shape[0] != self.dr:
                raise ValueError(
                    f"Ypad has {Ypad.shape[0]} rows, solver expects "
                    f"{self.dr} (pad the factor to a stable bucket)")
        else:
            Ypad = jnp.zeros((0, n), dtype=jnp.float64)
        key, sub = jax.random.split(key)
        if X0 is None:
            X0 = jax.random.normal(sub, (k, n), dtype=jnp.float64)
        else:
            X0 = jnp.asarray(X0, dtype=jnp.float64)
            if X0.shape[0] == n and (X0.ndim == 1 or X0.shape[1] != n):
                X0 = X0.T
            X0 = X0[:k]
        (lam_min, hi, num_neg, Xk, th_k, resid_k, j, scale,
         lo) = self._run(ctx, Ypad, X0, key, jnp.float64(tol),
                         jnp.int32(maxiter))
        # diagnostics (device scalars; materialized only if read)
        self.last = dict(iters=j, resid=resid_k, scale=scale, lo=lo,
                         hi=hi)
        return CertResult(lam_min=lam_min, lam_max=hi, num_neg=num_neg,
                          neg_vecs=Xk.T, neg_vals=th_k)


def lobpcg_rows(matvec_rows: Callable, n: int, k: int, key,
                maxiter: int = 200, tol: float = 1e-9,
                deflate=None, X0=None,
                matvec32: Optional[Callable] = None,
                switch_tol: float = 1e-5) -> CertResult:
    """One-shot functional wrapper (tests / ad-hoc use): matvecs take
    no ctx."""
    solver = RowCertSolver(
        lambda V, _: matvec_rows(V), n,
        (lambda V, _: matvec32(V)) if matvec32 is not None else None)
    return solver.solve((), key, k, X0=X0, deflate=deflate,
                        maxiter=maxiter, tol=tol, switch_tol=switch_tol)
