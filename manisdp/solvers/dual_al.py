"""Dual Riemannian-ADMM drivers.

    sup  <C,X> + <c,w>   s.t.  A(X) + B(w) = b,  X psd,  w free

factored through the dual slack S = Y'Y living on the manifold:

  - dual_unitdiag (oblique, diag(S)=1): src/dual/ManiDSDP_unitdiag.m —
    SOS duals of BQPs;
  - dual_general (Euclidean):           src/dual/ManiDSDP.m — SOS with
    general multipliers.

Per ADMM iteration: closed-form exact y-step (requires AA' diagonal),
RTR inner solve on Y, multiplier updates (x, w), and the PRIMAL matrix
X recovered from multipliers drives the eigendecomposition /
escape-direction machinery (ManiDSDP_unitdiag.m:80-88).

The multiplier x and the gradient matrix X-hat are dense n x n (as in
the reference); their products with Y are dense matmuls.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SolverOptions, merged_options
from ..core import Problem, TROptions, make_trustregions
from ..manifolds import Euclidean, Oblique
from ..ops.dualops import DualOp, SparseMat
from ..ops.eigs import dense_certificate, lobpcg_certificate
from .common import (JitCache, PhaseTimers, RankController, SDPResult,
                     SlowProgress, bucketed, log_iter,
                     make_line_search, pad_rows)


@dataclasses.dataclass(frozen=True)
class DualVariant:
    name: str
    manifold: type
    unitdiag: bool
    nne_floor: bool
    slow_period: int
    slow_warmup: int


DUAL_VARIANTS = {
    "dual_unitdiag": DualVariant("dual_unitdiag", Oblique, True, True,
                                 50, 100),
    "dual_general": DualVariant("dual_general", Euclidean, False, False,
                                20, 50),
}


def _dot_b(op, y):
    """<b, y> — ops with a truncated b (zeros beyond a prefix, e.g.
    SymDualOp's degree <= 2 support) expose dot_b to avoid carrying a
    length-m dense b (808 MB at q = 100)."""
    f = getattr(op, "dot_b", None)
    return f(y) if f is not None else jnp.dot(op.b, y)


def _scale_idAAt(op, v):
    """(AA')^{-1} v — ops with constant-per-degree class sizes expose
    scale_idAAt instead of a length-m idAAt array."""
    f = getattr(op, "scale_idAAt", None)
    return f(v) if f is not None else op.idAAt * v


def _B_rmatvec(op, y):
    """B' y for the free block; tuple m-space ops (SymDualOp) carry
    f = 0, so the product is empty without flattening y."""
    if isinstance(y, tuple):
        if op.f == 0:
            return jnp.zeros(0, dtype=jnp.float64)
        return op.B.rmatvec(op.flatten_y(y))
    return op.B.rmatvec(y)


def _common_cost(Y, op: DualOp, Xm, w, sigma):
    S = Y.T @ Y
    y = op.y_step(S)
    As = op.adjoint(y) - (S - op.C) - Xm / sigma
    Af = _B_rmatvec(op, y) - op.cf - w / sigma
    f = _dot_b(op, y) + 0.5 * sigma * \
        (jnp.sum(As * As) + jnp.dot(Af, Af))
    # SLIM aux: only (As, Af) — the gradients never read S or y, and
    # the TR while_loop CARRIES aux across iterations (plus an f32
    # cast inside tcg32), so keeping the (n, n) S and the q^4
    # y-tensor alive cost ~2.4 GB at q = 100 (the round-5 OOM margin)
    return f, (As, Af)


def _make_problem(variant: DualVariant, iAB: Optional[SparseMat]):
    M = variant.manifold

    def cost(Y, params):
        op, Xm, w, sigma = (params["op"], params["Xm"], params["w"],
                            params["sigma"])
        return _common_cost(Y, op, Xm, w, sigma)

    if variant.unitdiag:
        # ManiDSDP_unitdiag.m:183-194
        def grad(Y, params, aux):
            op, sigma = params["op"], params["sigma"]
            As, _ = aux
            Xh = op.bA - sigma * As
            eG = 2.0 * Y @ Xh
            YeG = jnp.sum(Y * eG, axis=0)
            return eG - Y * YeG[None, :], (Xh, YeG)

        def hess(Y, U, params, aux, gaux):
            op, sigma = params["op"], params["sigma"]
            Xh, YeG = gaux
            YU = Y.T @ U
            yAU = op.adjoint(_scale_idAAt(op, op.apply(YU)))
            eH = 2.0 * U @ Xh - 4.0 * sigma * (Y @ yAU) \
                + 2.0 * sigma * ((Y @ U.T) @ Y + (Y @ Y.T) @ U)
            return eH - Y * jnp.sum(Y * eH, axis=0, keepdims=True) \
                - U * YeG[None, :]
    else:
        # ManiDSDP.m:162-177
        def grad(Y, params, aux):
            op, sigma = params["op"], params["sigma"]
            As, Af = aux
            Xh = op.bA + sigma * (
                _iab_mat(iAB, op.n, Af)
                + op.adjoint(_scale_idAAt(op, op.apply(As))) - As)
            return 2.0 * Y @ Xh, (Xh, None)

        def hess(Y, U, params, aux, gaux):
            op, sigma = params["op"], params["sigma"]
            Xh, _ = gaux
            YU = U.T @ Y                       # <U[:,i], Y[:,j]> dense
            yAU = op.adjoint(_scale_idAAt(op, op.apply(YU)))
            t1 = _iab_mat(iAB, op.n, _iab_rmat(iAB, YU))
            t2 = op.adjoint(_scale_idAAt(op, op.apply(yAU)))
            return 2.0 * U @ Xh \
                + 2.0 * sigma * ((Y @ Y.T) @ U + (Y @ U.T) @ Y) \
                + 4.0 * sigma * (Y @ (t1 + t2 - 2.0 * yAU))

    def cost_only(Y, params):
        return cost(Y, params)[0]

    return Problem(manifold=M, cost=cost, grad=grad, hess=hess), cost_only


def _iab_mat(iAB: SparseMat, n: int, u):
    """mat(iAB @ u) -> dense (n, n); iAB rows are n^2 row-major."""
    flat = jnp.zeros(n * n, dtype=u.dtype)
    # iAB may be a closure in a lower-precision tCG trace: match dtypes
    flat = flat.at[iAB.row_c].add(
        iAB.val_c.astype(u.dtype) * jnp.take(u, iAB.col_c))
    return flat.reshape(n, n)


def _iab_rmat(iAB: SparseMat, M):
    """iAB' @ vec(M) -> (f,) for dense (n, n) M."""
    vals = jnp.take(M.reshape(-1), iAB.row_c)
    return jax.ops.segment_sum(iAB.val_c.astype(vals.dtype) * vals,
                               iAB.col_c, num_segments=iAB.ncols,
                               indices_are_sorted=True)


def _make_stats(variant: DualVariant, iAB: Optional[SparseMat]):

    @jax.jit
    def stats(Y, op, Xm, w, sigma, normc):
        # NOTE: S and y are NOT returned — holding them across outer
        # iterations kept ~1.6 GB alive at q = 100 (RESOURCE_EXHAUSTED
        # at iter 2); the driver recomputes them once at finalization.
        S = Y.T @ Y
        y = op.y_step(S)
        As = op.adjoint(y) - (S - op.C)
        Af = _B_rmatvec(op, y) - op.cf
        pinf = (jnp.sqrt(jnp.sum(As * As)) + jnp.linalg.norm(Af)) / normc
        by = _dot_b(op, y)
        if variant.unitdiag:
            # ManiDSDP_unitdiag.m:80-88
            Xm_new = Xm - sigma * As
            w_new = w - sigma * Af
            eX = Xm_new + op.bA
            z = jnp.sum(S * eX, axis=0)
            Xp = eX - jnp.diag(z)
            obj = jnp.sum(op.C * eX) + jnp.dot(op.cf, w_new) + jnp.sum(z)
        else:
            # ManiDSDP.m:73-77
            Xm_new = Xm + sigma * (
                _iab_mat(iAB, op.n, Af - w / sigma)
                + op.adjoint(_scale_idAAt(op, op.apply(As - Xm / sigma))) - As)
            w_new = w - sigma * Af
            eX = Xm_new + op.bA
            z = jnp.zeros(())
            Xp = eX
            obj = jnp.sum(op.C * eX) + jnp.dot(op.cf, w_new)
        gap = jnp.abs(obj - by) / (1.0 + jnp.abs(obj) + jnp.abs(by))
        return Xm_new, w_new, Xp, z, obj, pinf, by, gap

    return stats


# Cross-solve cache of jitted solver/stats closures.
# Entries are keyed on everything that shapes the trace (variant,
# budget, dtype config) and only populated for closures that capture no
# solve-specific data; see the factory in solve_dual_al.  Bounded in
# practice by the handful of (variant, tier) combinations a process
# touches.
_XSOLVE_CACHE: dict = {}


def solve_dual_al(variant_name: str, op: DualOp,
                  options: Optional[SolverOptions] = None,
                  iAB: Optional[SparseMat] = None,
                  Y0: Optional[np.ndarray] = None,
                  Xm0: Optional[np.ndarray] = None,
                  w0: Optional[np.ndarray] = None,
                  **overrides) -> SDPResult:
    variant = DUAL_VARIANTS[variant_name]
    opt = merged_options(variant.name, options, **overrides)
    n, m = op.n, op.m
    use_eigh = (opt.eig_method == "eigh") or \
        (opt.eig_method == "auto" and n < opt.eig_switch_n)
    k_cert = opt.delta + 1

    if opt.verbose:
        print(f"ManiSDP-JAX ({variant.name}) is starting...", flush=True)
        # expanded operators carry an inflated flat residual length;
        # report the true constraint count (reference parity)
        print(f"SDP size: n = {n}, m = {getattr(op, 'm_true', m)}",
              flush=True)

    problem, cost_only = _make_problem(variant, iAB)
    # Two TR budgets: the reference-default one (tier 0) and an escalated
    # endgame budget (tier 1) engaged when the sigma controller freezes
    # with dinf the only blocking residual — same mechanism as the primal
    # AL drivers (see primal_al.py and NOTES.md theta-class analysis).
    def budget(tier, use32):
        kw = dict(tolgradnorm=opt.tolgradnorm,
                  tcg_dtype="float32" if use32 else None)
        if tier == 0:
            return TROptions(maxiter=opt.tr_maxiter,
                             maxinner=opt.tr_maxinner, **kw)
        return TROptions(maxiter=max(opt.boost_tr_maxiter, opt.tr_maxiter),
                         maxinner=max(opt.boost_tr_maxinner,
                                      opt.tr_maxinner), **kw)
    M = variant.manifold

    op32 = iab32 = problem32 = None
    if opt.inner_dtype == "mixed":
        cast32 = lambda x: x.astype(jnp.float32) \
            if jnp.issubdtype(x.dtype, jnp.floating) else x
        op32 = jax.tree_util.tree_map(cast32, op)
        if iAB is not None:
            iab32 = jax.tree_util.tree_map(cast32, iAB)
        problem32, _ = _make_problem(variant, iab32)

    def factory(key):
        _, tier, u32 = key
        # Cross-SOLVE closure reuse: the unitdiag problem closures
        # capture NO solve-specific arrays (op/Xm/w/sigma all travel
        # through ``params``), so the jitted callable is reusable
        # across solve calls with identical variant + budget + dtype
        # config.  Reusing the SAME jax.jit object lets the in-process
        # executable cache hit on the warm run instead of re-tracing
        # and re-LOADING every program from the persistent compile
        # cache.  Gated off whenever iAB is present (the
        # general-variant closures capture it) or inner_dtype="mixed"
        # (problem32 captures op32).
        ck = None
        if iAB is None and opt.inner_dtype != "mixed":
            import os as _os
            ck = (variant_name, dataclasses.astuple(budget(tier, u32)),
                  opt.inner_dtype, opt.line_search,
                  _os.environ.get("MANISDP_LS_TAIL"))
            hit = _XSOLVE_CACHE.get(ck)
            if hit is not None:
                return hit
        solve = jax.jit(make_trustregions(problem, budget(tier, u32)))
        ls = make_line_search(
            cost_only, M.renormalize,
            ls_dtype="float32" if opt.inner_dtype == "tcg32" else None)
        solve32 = None
        if opt.inner_dtype == "mixed":
            # f32 pre-stage of the inner solve (same dtype-generic RTR
            # core as the primal drivers); certificates, multiplier
            # updates and the y-step stay f64, so the 1e-8 KKT
            # certification is unaffected.
            t = budget(tier, False)
            tr32 = TROptions(maxiter=t.maxiter, maxinner=t.maxinner,
                             tolgradnorm=max(opt.mixed_tolgradnorm,
                                             t.tolgradnorm))
            solve32 = jax.jit(make_trustregions(problem32, tr32))
        out = (solve, solve32, ls)
        if ck is not None:
            _XSOLVE_CACHE[ck] = out
        return out

    cache = JitCache(factory)
    # stats closures are likewise data-free when iAB is None — reuse
    # the jitted stats program across solves (same rationale as above)
    if iAB is None:
        sk = ("stats", variant_name)
        stats_fn = _XSOLVE_CACHE.get(sk)
        if stats_fn is None:
            stats_fn = _make_stats(variant, iAB)
            _XSOLVE_CACHE[sk] = stats_fn
    else:
        stats_fn = _make_stats(variant, iAB)

    # Two-tier warm-started LOBPCG certificate (same scheme as the
    # maxcut driver): the warm budget rides the previous iteration's
    # Ritz block; the full budget is paid only when accuracy decides
    # convergence.  Certification stays sound either way — lam_min is a
    # residual-backed lower bound (ops/eigs.py).
    # NOTE: named cert32 (not use32) — the RTR loop's use32 flag below
    # would otherwise shadow this before the jitted closures trace,
    # silently gating the f32 LOBPCG pre-stage on inner_dtype.
    # Exact certificate in the COMPRESSED original basis for expanded
    # (duplicated) operators: at the optimum the expanded primal X~ has
    # an (n~ - rank)-fold ZERO cluster that no iterative residual
    # bound can certify below 1e-8 (the LOBPCG dinf floors at its
    # residual, ~1e-6, and the escape machinery keeps appending junk
    # forever).  Compressing to the original n_orig-dim matrix (one
    # gather per OUTER iteration) and running one exact device f64
    # eigh there reproduces the reference's certificate exactly
    # (ManiDSDP_unitdiag.m:84): lam(X~) = lam(X_orig)/2 plus zeros.
    compress = getattr(op, "compress", None)
    if compress is not None:
        def exact_cert(Xp_dev):
            res = dense_certificate(compress(Xp_dev), k_cert)
            lam_min = min(float(res.lam_min) / 2.0, 0.0)
            lam_max = max(float(res.lam_max) / 2.0, 0.0)
            return lam_min, lam_max, int(res.num_neg), op.lift_vecs(
                np.asarray(jax.device_get(res.neg_vecs)))
    else:
        exact_cert = None

    if exact_cert is not None or use_eigh:
        lob_cert = None
    elif opt.cert_method == "devrr" and n > 3 * k_cert:
        # Fully device-resident certificate (ops/eigs_rr.DeviceCertSolver):
        # one dispatch per call; the primal-recovery matrix Xp is dense,
        # so the row matvec is one matmul V @ Xp (Xp symmetric).
        # While far from convergence (max(gap, pinf) > cert_cheap_eta)
        # the warm solve runs the cheap budget — only the escape
        # directions matter there, not a tight lam_min bound.
        from ..ops.eigs_rr import DeviceCertSolver
        cert_solver = DeviceCertSolver(lambda V, Xp: V @ Xp, n, k_cert)
        cert_warm = {"X0": None}

        def lob_cert(Xp, key, gap, pinf):
            # gate on max(cert_cheap_eta, tol) so a loose
            # user tol never terminates off the cheap-budget solve
            far = max(gap, pinf) > max(opt.cert_cheap_eta, opt.tol)
            mi = opt.lobpcg_maxiter_cheap if far \
                else opt.lobpcg_maxiter_warm
            res = cert_solver.solve(Xp, key, X0=cert_warm["X0"],
                                    maxiter=mi, tol=opt.cert_inner_tol)
            if not far:
                lam_max = abs(float(res.lam_max))
                cons = max(0.0, -float(res.lam_min)) / (1.0 + lam_max)
                optm = max(0.0, -float(res.neg_vals[0])) / \
                    (1.0 + lam_max)
                if cons >= opt.tol and optm < opt.tol:
                    # accuracy decides convergence -> full budget
                    res = cert_solver.solve(
                        Xp, key, X0=res.neg_vecs,
                        maxiter=opt.lobpcg_maxiter, tol=opt.cert_inner_tol)
            cert_warm["X0"] = res.neg_vecs
            return res
    elif opt.cert_method in ("rowrr", "devrr"):
        # (devrr lands here when n <= 3*k_cert — too small for the
        # fixed-block device program; the host-RR path has no minimum)
        # row-layout LOBPCG + host Rayleigh-Ritz (ops/eigs_rr.py); the
        # primal-recovery matrix Xp is dense, so the row matvec is one
        # matmul V @ Xp (Xp symmetric).
        from ..ops.eigs_rr import RowCertSolver
        cert32 = opt.cert_pre_dtype in ("float32", "auto")
        mvr = lambda V, Xp: V @ Xp
        rr_solver = RowCertSolver(mvr, n, mvr if cert32 else None)
        cert_warm = {"X0": None}

        def lob_cert(Xp, key, gap, pinf):
            X0 = cert_warm["X0"]
            if X0 is None:
                res = rr_solver.solve(Xp, key, k_cert,
                                      maxiter=opt.lobpcg_maxiter,
                                      tol=opt.cert_inner_tol)
            else:
                res = rr_solver.solve(Xp, key, k_cert, X0=X0,
                                      maxiter=opt.lobpcg_maxiter_warm,
                                      tol=opt.cert_inner_tol)
                lam_max = abs(float(res.lam_max))
                cons = max(0.0, -float(res.lam_min)) / (1.0 + lam_max)
                optm = max(0.0, -float(res.neg_vals[0])) / (1.0 + lam_max)
                if (cons >= opt.tol and optm < opt.tol and
                        gap < opt.tol and pinf < opt.tol):
                    # accuracy decides convergence -> full budget
                    res = rr_solver.solve(Xp, key, k_cert,
                                          X0=res.neg_vecs,
                                          maxiter=opt.lobpcg_maxiter,
                                          tol=opt.cert_inner_tol)
            cert_warm["X0"] = res.neg_vecs
            return res
    else:
        cert32 = opt.cert_pre_dtype == "float32"

        def _lob(maxiter):
            @jax.jit
            def f(Xp, key, X0):
                matvec32 = None
                if cert32:
                    Xp32 = Xp.astype(jnp.float32)
                    matvec32 = lambda V: Xp32 @ V
                return lobpcg_certificate(lambda V: Xp @ V, n, k_cert,
                                          key, X0=X0, maxiter=maxiter,
                                          matvec32=matvec32,
                                          refine_iters=opt.lobpcg_refine)
            return f

        lob_full = _lob(opt.lobpcg_maxiter)
        lob_warm = _lob(opt.lobpcg_maxiter_warm)
        cert_warm = {"X0": None}

        def lob_cert(Xp, key, gap, pinf):
            X0 = cert_warm["X0"]
            if X0 is None:
                X0 = jax.random.normal(
                    jax.random.fold_in(key, 1), (n, k_cert),
                    dtype=jnp.float64)
                res = lob_full(Xp, key, X0)
            else:
                res = lob_warm(Xp, key, X0)
                lam_max = abs(float(res.lam_max))
                cons = max(0.0, -float(res.lam_min)) / (1.0 + lam_max)
                optm = max(0.0, -float(res.neg_vals[0])) / (1.0 + lam_max)
                if (cons >= opt.tol and optm < opt.tol and
                        gap < opt.tol and pinf < opt.tol):
                    # accuracy decides convergence -> pay the full budget
                    res = lob_full(Xp, key, res.neg_vecs)
            cert_warm["X0"] = res.neg_vecs
            return res

    rank = RankController(opt.theta, opt.delta, opt.alpha,
                          nne_floor=variant.nne_floor, bucket=opt.p_bucket)
    slow = SlowProgress(variant.slow_period, variant.slow_warmup)

    normc = float(1.0 + np.sqrt(
        float(jnp.sum(op.C * op.C)) + float(jnp.dot(op.cf, op.cf))))

    key = jax.random.PRNGKey(opt.seed)
    # ManiDSDP_unitdiag.m:11 default p0 = ceil(log(m))
    p = opt.p0 if opt.p0 > 0 else max(int(np.ceil(np.log(max(m, 2)))), 1)
    p_pad = bucketed(p, opt.p_bucket)
    if Y0 is not None:
        Y0 = np.asarray(Y0, dtype=np.float64)
        if Y0.shape[1] != n:
            Y0 = Y0.T
        p = Y0.shape[0]
        p_pad = max(p_pad, bucketed(p, opt.p_bucket))
        Y = jnp.asarray(pad_rows(Y0, p_pad))
    else:
        key, sub = jax.random.split(key)
        Y = M.rand(sub, p, n, p_pad)
    # operators over a redundant basis (ops/symdual.SymDualOp) supply a
    # symmetrize hook: the init, every rebuilt factor, and every escape
    # direction are projected onto the duplicate-symmetric subspace,
    # where the expanded dynamics reproduce the reference trajectory
    # (asymmetric drift from random inits / f32 tCG noise otherwise
    # stalls the inner solve and limit-cycles the sigma controller)
    symmetrize = getattr(op, "symmetrize", None)
    if symmetrize is not None:
        Y = symmetrize(Y)
    U_dir = None

    Xm = jnp.zeros((n, n)) if Xm0 is None else jnp.asarray(Xm0)
    w = jnp.zeros(op.f) if w0 is None else jnp.asarray(
        np.asarray(w0, dtype=np.float64).ravel())
    sigma = opt.sigma0
    status = 0
    total_tr = total_hess = fallbacks = 0
    fac_size, history = [], []
    t0 = time.time()
    obj = gap = pinf = dinf = gradnorm = eta = np.nan
    S_dev = y_dev = Xp_dev = z_dev = None
    it = 0
    tier = 0
    use32 = opt.inner_dtype == "tcg32"
    frozen = 0          # consecutive endgame iterations with frozen sigma
    best_eta = np.inf
    last_improve = 0
    pinf_anchor = np.inf    # sigma_push state: pinf at last sigma raise
    anchor_it = 0
    hold_boost = -1         # boost held through terminal-escape recovery
    best_pinf = np.inf      # ramp trigger state: best pinf, last halve
    pinf_improve_it = 0
    term_dinf = None        # dinf at the previous terminal gentle escape

    timers = PhaseTimers()
    for it in range(1, opt.max_outer + 1):
        fac_size.append(p)
        solve, solve32, line_search = cache((p_pad, tier, use32))
        params = dict(op=op, Xm=Xm, w=w, sigma=jnp.float64(sigma))
        with timers.timed("rtr"):
            if U_dir is not None:
                Y = line_search(Y, jnp.asarray(U_dir), params)
            typdist = float(M.typicaldist(p, n))
            # f32 pre-stage: skipped in the endgame tier and whenever the
            # previous f64 gradnorm already sits at/below the f32 target
            # (the noise floor would burn the whole budget for nothing)
            if solve32 is not None and tier == 0 and not \
                    (np.isfinite(gradnorm) and
                     gradnorm <= opt.mixed_tolgradnorm):
                params32 = dict(op=op32, Xm=Xm.astype(jnp.float32),
                                w=w.astype(jnp.float32),
                                sigma=jnp.float32(sigma))
                res32 = jax.block_until_ready(
                    solve32(Y.astype(jnp.float32), params32, typdist))
                Y = M.renormalize(res32.Y.astype(jnp.float64))
                total_tr += int(res32.iters)
                total_hess += int(res32.inner_iters)
            res = jax.block_until_ready(solve(Y, params, typdist))
            Y = res.Y
            if symmetrize is not None:
                # project the inner solve's output before stats/cert
                # consume it (f32 tCG noise leaves the subspace);
                # columns are post-retraction unit vectors here, so
                # renormalizing the averaged copies is exact
                Y = symmetrize(Y)
        gradnorm = float(res.norm_grad)
        total_tr += int(res.iters)
        total_hess += int(res.inner_iters)

        with timers.timed("stats"):
            (Xm, w, Xp_dev, z_dev, obj_d, pinf_d, by_d,
             gap_d) = stats_fn(Y, op, Xm, w, jnp.float64(sigma), normc)
            if symmetrize is not None:
                # keep the multiplier on the duplicate-symmetric
                # subspace — asymmetric accumulation shifts the AL
                # stationary point off-subspace and floors pinf
                Xm = op.symmetrize_mat(Xm)
                Xp_dev = op.symmetrize_mat(Xp_dev)
            obj, pinf, gap = float(obj_d), float(pinf_d), float(gap_d)

        with timers.timed("cert"):
            if exact_cert is not None:
                lam_min, lam_max, num_neg, neg_vecs = exact_cert(Xp_dev)
            elif use_eigh:
                cres = dense_certificate(Xp_dev, k_cert)
                lam_min = float(cres.lam_min)
                lam_max = float(cres.lam_max)
                num_neg = int(cres.num_neg)
                neg_vecs = np.asarray(jax.device_get(cres.neg_vecs))
            else:
                key, sub = jax.random.split(key)
                cres = lob_cert(Xp_dev, sub, gap, pinf)
                lam_min = float(cres.lam_min)
                lam_max = float(cres.lam_max)
                num_neg = int(cres.num_neg)
                neg_vecs = np.asarray(jax.device_get(cres.neg_vecs))
        # note abs() in the denominator (ManiDSDP_unitdiag.m:88)
        dinf = max(0.0, -lam_min) / (1.0 + abs(lam_max))

        with timers.timed("rank"):
            r, e_sv, Ul = rank.truncation(Y, p)
        log_iter(opt.verbose, it, obj, gap=gap, pinf=pinf, dinf=dinf,
                 gradnorm=gradnorm, r=r, p=p, sigma=sigma, t0=t0)
        history.append(dict(iter=it, obj=obj, gap=gap, pinf=pinf, dinf=dinf,
                            gradnorm=gradnorm, r=r, p=p, sigma=sigma,
                            tr=int(res.iters), hv=int(res.inner_iters)))
        timers.log_delta(opt.verbose)
        eta = max(gap, pinf, dinf)
        # eta-stagnation boost trigger: the frozen-sigma trigger below
        # misses plateaus where the controller OSCILLATES (gradnorm
        # spikes from the per-iteration escape steps flip the tau
        # comparisons); if the best eta hasn't halved for a while with
        # the gap already small, the subproblems are under-resolved
        # regardless of what sigma is doing (observed at random d=80:
        # 100 iterations of pinf in [2, 25] with sigma toggling)
        if eta < 0.5 * best_eta:
            best_eta = eta
            last_improve = it
        if (opt.endgame_boost and tier == 0 and gap <= 1e-3 and
                eta > opt.tol and it - last_improve >= 2 * opt.boost_after):
            tier = 1
        # ramp-phase trigger (config.ramp_deep_after): a long rank ramp
        # can hover at the pinf ~ tau2*gradnorm controller boundary —
        # sigma toggles up/down every iteration (which starves
        # sigma_push, whose anchor resets on every sigma raise), the
        # gap bounces around 1e-3 (which starves the gap-gated
        # triggers), and pinf wanders O(10-100) for 40+ outers with
        # dinf already tiny (observed at q = 100: 82 outers, tier
        # pinned to 0, sigma oscillating 0.002-0.064).  The robust
        # stuck-ramp signature is that the BEST pinf stops halving:
        # when that stalls for ramp_deep_after tier-0 outers while the
        # gap is small-ish, force the deep tier so gradnorm collapses
        # and the tau2 comparison can ramp sigma decisively (the AL
        # convergence event); progress-gated decay returns to tier 0.
        if tier == 1:
            best_pinf = pinf
            pinf_improve_it = it
        else:
            if pinf < 0.5 * best_pinf:
                best_pinf = pinf
                pinf_improve_it = it
            if (opt.endgame_boost and opt.ramp_deep_after and
                    gap <= opt.ramp_deep_gap and pinf > opt.tol and
                    eta > opt.tol and
                    it - pinf_improve_it >= opt.ramp_deep_after):
                tier = 1
                pinf_improve_it = it
        if eta < opt.tol:
            if opt.verbose:
                print("Optimality is reached!", flush=True)
            break
        if slow.check(it, gap, pinf, dinf):
            if use32:
                # precision fallback: f32 tCG directions can stall on
                # very ill-conditioned subproblems; demote the inner
                # loop to f64 and keep going instead of bailing
                use32 = False
                fallbacks += 1
                slow.prev = None
                if opt.verbose:
                    print("Slow progress under tcg32 -> f64 inner "
                          "fallback", flush=True)
            else:
                status = 2
                if opt.verbose:
                    print("Slow progress!", flush=True)
                break

        Y_host = np.asarray(jax.device_get(Y))
        if r <= p - 1:
            Y_host = Ul[:, :r].T @ Y_host
            p = r
        else:
            Y_host = Y_host[:p]
        # no escape when the dual certificate is NOT the blocker: the
        # reference's nne >= 1 floor (ManiDSDP_unitdiag.m:117) exists
        # to keep exploring while dinf blocks, but when only pinf
        # remains, appending a junk direction perturbs the converged
        # low-rank point and the endgame ping-pongs for dozens of
        # iterations (observed at bqp q=60: a deep solve reached
        # gradnorm 3.5e-7 / dinf 5.3e-8 / pinf 0.21, then the dinf >
        # tol escape re-excited everything and the solve wandered 120
        # more outers from iteration 30).  dinf is "not the
        # blocker" when it sits at max(tol, well below both pinf and
        # an absolute near-convergence level).
        # 1e-2 (not 1e-3): with the round-5 memory-diet trajectory the
        # q=60 endgame reached gap 2.5e-10 / pinf 2.2e-5 / dinf 7.9e-8
        # at iter 25 and the 1e-3 floor (2.2e-8) still let the escape
        # fire — pinf re-excited to 0.75 and the solve burned 27 more
        # outers re-converging (iterations 25-52).  Two orders below
        # pinf is still decisively "pinf is the blocker"; once pinf
        # itself reaches tol the terminal
        # gentle escape handles any residual dinf.
        esc_ls = opt.line_search
        dinf_floor = max(opt.tol, min(1e-5, 1e-2 * pinf))
        pinf_lock = (opt.endgame_boost and gap <= 1e-3 and
                     dinf <= dinf_floor and pinf > opt.tol)
        if pinf_lock:
            # pinf is the lone blocker: hold the deep-solve tier so
            # gradnorm collapses every outer and the tau2 comparison
            # ramps sigma (the AL convergence event); escapes stay off
            tier = 1
        nne = rank.num_escape(num_neg) if dinf > dinf_floor else 0
        if nne and pinf <= opt.tol and gap <= opt.tol:
            # terminal gentle escape: gap/pinf are DONE and only dinf
            # marginally fails — append ONLY the most negative
            # direction AND force a deep next solve so the multiplier
            # update reflects a fully re-minimized point.  A
            # delta-sized escape followed by a shallow solve at the
            # converged rank-1 point re-excites pinf to O(1) and
            # restarts a 15-iteration ramp cycle (observed at q = 60,
            # iterations 32-47, for a dinf of 2.6e-8).
            nne = 1
            if opt.endgame_boost:
                tier = 1
                hold_boost = it + 3     # hold through the recovery
            # terminal limit-cycle breaker: when the line-searched
            # gentle kick fails to contract dinf by >= 25% per cycle,
            # the step is too timid (the decrease from a ~1e-7
            # curvature direction sits below the f32 line-search noise
            # floor, so alpha collapses to ~0) — observed at q = 80:
            # five cycles shaved dinf 2.5e-7 -> 1.7e-7 (iterations
            # 63-71).  Fall back to
            # the reference's constant alpha-sized append
            # (ManiDSDP_unitdiag.m:117-121) whose decisive kick the
            # held deep solve then absorbs with the proper weight.
            if term_dinf is not None and dinf > 0.75 * term_dinf:
                esc_ls = False
            term_dinf = dinf
        elif pinf > 1e-2 or gap > 1e-4:
            # left the terminal regime -> reset.  NOT on every
            # non-terminal iteration: each gentle escape's recovery
            # iteration has pinf ~ 1e3*tol and a per-iteration reset
            # blinded the cycle detector (observed at q = 80,
            # iterations 63-75: dinf stuck at ~2e-7 with term_dinf
            # wiped every other outer).
            term_dinf = None
        vs = neg_vecs[:, :nne]
        if symmetrize is not None:
            # duplicated-basis correspondence: the lift of a unit
            # original eigenvector has expanded norm sqrt(2), but the
            # certificate returns unit expanded vectors — rescale so
            # the escape step matches the reference trajectory's
            # (otherwise every escape is sqrt(2) undersized and the
            # line search cannot reach the corresponding alpha)
            vs = np.sqrt(2.0) * vs
        if nne == 0:
            U_host = None
        elif esc_ls:
            U_host = np.vstack([np.zeros((p, n)), vs.T])
            Y_host = np.vstack([Y_host, np.zeros((nne, n))])
        else:
            U_host = None
            Y_host = np.vstack([Y_host, opt.alpha * vs.T])
            if variant.manifold is Oblique:
                Y_host = Y_host / np.sqrt(np.sum(Y_host ** 2, axis=0))
        p = p + nne
        # rank buckets grow eagerly but SHRINK only when the active
        # rank collapses to half a bucket or less — the endgame of a
        # big rank ramp otherwise keeps paying the peak bucket's
        # matmul cost for every remaining iteration (bqp q=60: rank
        # 151 -> 2 while p_pad stayed 192, tripling every endgame Hv)
        p_need = bucketed(p, opt.p_bucket)
        if p_need > p_pad or 2 * p_need <= p_pad:
            p_pad = p_need
        Y = jnp.asarray(pad_rows(Y_host, p_pad))
        U_dir = pad_rows(U_host, p_pad) if U_host is not None else None
        if symmetrize is not None:
            # renorm=False: after a rank truncation the column norms
            # are NOT unit, and the reference only renormalizes inside
            # the retraction of the STEPPED point
            # (ManiDSDP_unitdiag.m:94,117-121) — normalizing the base
            # point first is a different manifold point and was
            # observed to bounce pinf 50x at every deep truncation
            Y = symmetrize(Y, renorm=False)
            if U_dir is not None:
                U_dir = symmetrize(U_dir, renorm=False)

        sigma_prev = sigma
        # boost decays only on actual PROGRESS (eta halved recently),
        # not on mere sigma movement: with an aggressive tau2 (e.g. the
        # q >= 70 recipe) the controller moves every iteration, and a
        # move-triggered reset killed the stagnation boost before its
        # deep solve ever ran (observed at q = 80: 60+ outers at rank
        # 300+ with tier pinned to 0)
        boost_decay = (not pinf_lock) and (it - last_improve <= 1) \
            and it > hold_boost
        if pinf < opt.tau1 * gradnorm:
            sigma = max(sigma / opt.gama, opt.sigma_min)
            frozen = 0
            if boost_decay:
                tier = 0    # boost served its purpose: progress resumed
        elif pinf > opt.tau2 * gradnorm:
            sigma = min(sigma * opt.gama, opt.sigma_max)
            frozen = 0
            if boost_decay:
                tier = 0
        else:
            # plateau boost: the sigma controller freezes whenever
            # tau1*gradnorm < pinf < tau2*gradnorm.  The convergence
            # event of this ADMM is "deep inner solve -> gradnorm
            # collapses -> sigma ramps -> pinf contracts
            # superlinearly" (visible in every successful reference
            # trajectory); when the default 4x20 TR budget leaves
            # gradnorm ~1e-2, the controller freezes and the solve
            # plateaus indefinitely at pinf ~0.2-1 (observed at bqp
            # q=60 across containers — the trajectory is chaotically
            # sensitive, and a lucky basin is the only way through at
            # tier 0).  Escalate the TR budget after boost_after
            # consecutive frozen iterations once the gap is small;
            # the deeper subproblem solves re-enable the controller.
            if (opt.endgame_boost and tier == 0 and
                    gap <= 1e-3 and eta > opt.tol):
                frozen += 1
                if frozen >= opt.boost_after:
                    tier = 1
            else:
                frozen = 0

        # forced sigma escalation on pinf stagnation (config.py
        # sigma_push): the tau controller compares pinf against
        # gradnorm, but when the inner budget leaves gradnorm O(1e-1)
        # it can wander at sigma ~ sigma_min for 100+ outers with pinf
        # O(1) (observed at q = 80).  If sigma hasn't increased and pinf
        # hasn't contracted by sigma_push_ratio for sigma_push_after
        # iterations while the gap is small, feasibility needs a
        # bigger penalty regardless of gradnorm — the same judgement
        # behind the reference's own per-instance tau2=10 recipe
        # (example/dual/example_bqp_dual.m:36, "% q = 80, i = 3").
        if opt.sigma_push:
            if sigma > sigma_prev or \
                    pinf < opt.sigma_push_ratio * pinf_anchor:
                pinf_anchor = pinf
                anchor_it = it
            elif (gap <= opt.sigma_push_gap and pinf > opt.tol and
                  eta > opt.tol and it - anchor_it >= opt.sigma_push_after):
                sigma = min(sigma * opt.gama, opt.sigma_max)
                pinf_anchor = pinf
                anchor_it = it

        # checkpoint AFTER the sigma update so resuming with
        # sigma0=st["sigma"] continues the exact trajectory
        if opt.checkpoint_every and opt.checkpoint_path and \
                it % opt.checkpoint_every == 0:
            from ..utils.checkpoint import save_state
            save_state(opt.checkpoint_path,
                       Y=np.asarray(jax.device_get(Y))[:p],
                       w=np.asarray(jax.device_get(w)),
                       Xm=np.asarray(jax.device_get(Xm)), sigma=sigma,
                       tier=tier, iteration=it)
    else:
        it = opt.max_outer

    if status == 0 and eta > opt.tol:
        status = 1
        if opt.verbose:
            print("Iteration maximum is reached!", flush=True)

    elapsed = time.time() - t0
    if opt.verbose:
        print(f"ManiDSDP-JAX: optimum = {obj:0.8f}, time = {elapsed:0.2f}s",
              flush=True)

    Y_act = np.asarray(jax.device_get(Y))[:p]
    # finalize S / y from the factor (not held during the loop — the
    # q^4 y-tensor and the (n, n) S cost ~1.6 GB of liveness at q=100)
    if it > 0 and Xp_dev is not None:
        S_dev = Y.T @ Y
        y_dev = op.y_step(S_dev)
    if y_dev is not None and hasattr(op, "flatten_y"):
        y_dev = op.flatten_y(y_dev)
    return SDPResult(
        X=np.asarray(jax.device_get(Xp_dev)) if Xp_dev is not None else None,
        obj=obj, Y=Y_act,
        y=np.asarray(jax.device_get(y_dev)) if y_dev is not None else None,
        S=np.asarray(jax.device_get(S_dev)) if S_dev is not None else None,
        z=np.asarray(jax.device_get(z_dev)) if z_dev is not None else None,
        gap=gap, pinf=pinf, dinf=dinf, eta=eta, gradnorm=gradnorm,
        time=elapsed, status=status, iterations=it, fac_size=fac_size,
        rtr_iters=total_tr, hess_calls=total_hess,
        precision_fallbacks=fallbacks, history=history,
        timers=timers.t, sigma=sigma, tier=tier)
