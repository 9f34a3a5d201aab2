"""Unit-diagonal SDP without extra affine constraints (MaxCut family).

    min <C, X>  s.t.  diag(X) = 1,  X >= 0

JAX equivalent of ManiSDP_onlyunitdiag
(src/primal/ManiSDP_onlyunitdiag.m): the unit-diagonal constraint IS the
oblique manifold, so the outer loop needs no augmented Lagrangian — it
alternates [RTR inner solve -> dual certificate -> rank update].

Everything on the hot path is factored/sparse:
  cost  f  = 0.5 <Y C, Y>                       (:117-121)
  grad  G  = YC - Y .* colsum(Y .* YC)          (:123-125)
  hess  H  = UC - Y .* colsum(Y .* UC) - U .* eG(:127-130)
  dual  S  = C - diag(z),  z = colsum(C .* X)   (:45-49)
with Y a zero-padded (p_pad, n) factor and C a SymCOO; the n^3 dense
eig of S is replaced by a matrix-free LOBPCG certificate for large n.
"""

from __future__ import annotations

import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SolverOptions, merged_options
from ..core import Problem, TROptions, make_trustregions
from ..manifolds import Oblique
from ..ops.eigs import dense_certificate, lobpcg_certificate
from ..ops.sparse import SymCOO
from .common import (JitCache, PhaseTimers, RankController, SDPResult,
                     SlowProgress, bucketed, log_iter,
                     make_line_search, pad_rows)


def make_maxcut_problem(dense: bool = True) -> Problem:
    """cost/grad/hess of the oblique MaxCut subproblem
    (ManiSDP_onlyunitdiag.m:117-130).

    ``dense``: C arrives as a dense (n, n) array and the hot products
    Y@C / U@C are matmuls.  Sparse mode takes a SymCOO (gather /
    segment-sum products) for large sparse C (the G67 class,
    n = 10^4); the switch is config.dense_cost_max_n.

    Shared by the single-chip driver and the mesh-sharded paths in
    parallel/mesh.py, so they cannot drift.
    """

    def matc(M, C):
        return M @ C if dense else C.matmat(M)

    def cost(Y, C):
        YC = matc(Y, C)
        eG = jnp.sum(YC * Y, axis=0)
        return 0.5 * jnp.sum(eG), (YC, eG)

    def grad(Y, C, aux):
        YC, eG = aux
        return YC - Y * eG[None, :], ()

    def hess(Y, U, C, aux, gaux):
        _, eG = aux
        UC = matc(U, C)
        return UC - Y * jnp.sum(Y * UC, axis=0, keepdims=True) \
            - U * eG[None, :]

    return Problem(manifold=Oblique, cost=cost, grad=grad, hess=hess)


_XSOLVE_CACHE: dict = {}


def _make_inner(opt: SolverOptions, dense: bool, use32: bool = None):
    """RTR solve + certificate, jit-cached per (p_pad, use32).

    The closures capture no solve-specific data (the cost matrix C
    rides as an argument), so they are reused ACROSS solve calls via a
    module-level cache keyed on everything that shapes the trace —
    warm runs and repeat trials then hit the in-process executable
    cache instead of re-tracing and re-loading programs from the
    persistent compile cache (same scheme as dual_al/primal_al)."""
    problem = make_maxcut_problem(dense)
    cost = problem.cost
    if use32 is None:
        use32 = opt.inner_dtype == "tcg32"
    ck = (dense, use32, opt.tr_maxiter, opt.tr_maxinner,
          float(opt.tolgradnorm), opt.inner_dtype,
          float(opt.mixed_tolgradnorm))
    hit = _XSOLVE_CACHE.get(ck)
    if hit is not None:
        return hit
    tcg_dt = "float32" if use32 else None
    tr_opts = TROptions(maxiter=opt.tr_maxiter, maxinner=opt.tr_maxinner,
                        tolgradnorm=opt.tolgradnorm, tcg_dtype=tcg_dt)
    solve = jax.jit(make_trustregions(problem, tr_opts))

    solve32 = None
    if opt.inner_dtype == "mixed":
        # f32 pre-stage: same RTR program traced on float32 inputs (the
        # core is dtype-generic), stopping at the loose mixed tolerance.
        tr32 = TROptions(maxiter=opt.tr_maxiter, maxinner=opt.tr_maxinner,
                         tolgradnorm=max(opt.mixed_tolgradnorm,
                                         opt.tolgradnorm))
        solve32 = jax.jit(make_trustregions(problem, tr32))

    def cost_only(Y, C):
        return cost(Y, C)[0]

    line_search = make_line_search(cost_only, Oblique.renormalize)
    out = (solve, solve32, line_search)
    _XSOLVE_CACHE[ck] = out
    return out


def _make_cert(opt: SolverOptions, n: int, k: int, use_eigh: bool,
               dense: bool):
    """Dual certificate for S = C - diag(z).

    Moderate n: one dense f64 eigh on the device; large n: a
    matrix-free device Lanczos + LOBPCG (ops/eigs_rr.py, ops/eigs.py).
    """

    @jax.jit
    def z_obj(Y, C):
        if dense:
            z = jnp.sum(Y * (Y @ C), axis=0)
        else:
            z = C.quad_cols(Y)
        return z, jnp.sum(z)

    # size gate: the device-cert program needs
    # n > 3 * block with block = k + deflation augmentation (the
    # constructor raises otherwise, and lazily constructing it
    # mid-solve would abort the iteration); small n falls through to
    # the host-RR / eigh paths below, same as dual_al.py.
    _b_cert = max(k, min((n - 1) // 5, 24))
    if opt.cert_method == "devrr" and not use_eigh and n > 3 * _b_cert:
        # Fully device-resident certificate (ops/eigs_rr.DeviceCertSolver):
        # one dispatch per call; S = C - diag(z) applied as rows.  The
        # factor is padded to cert_p_bucket rows so the program compiles
        # once per run even as the rank shrinks/grows.
        from ..ops.eigs_rr import DeviceCertSolver, RowCertSolver
        from .common import bucketed as _bucketed

        def mvr(V, ctx):
            CV = V @ ctx["C"] if dense else ctx["C"].matmat(V)
            return CV - ctx["z"][None, :] * V

        solvers = {}
        warm = {"X0": None}
        # accuracy-deciding retry: host-RR LOBPCG with a LARGE block
        # (cert_big_block rows), wide enough to cover the near-null
        # cluster the warm 24-row device cert stalls on (the sound
        # Kato-Temple bound needs a witness above the whole cluster)
        rr_retry = RowCertSolver(mvr, n)

        def cert(Y, C, key):
            z, obj = z_obj(Y, C)
            ctx = dict(C=C, z=z)
            dr = _bucketed(Y.shape[0], opt.cert_p_bucket)
            solver = solvers.get(dr)
            if solver is None:
                solver = DeviceCertSolver(mvr, n, k, deflate_rows=dr)
                solvers[dr] = solver
            Ypad = Y if Y.shape[0] == dr else jnp.concatenate(
                [Y, jnp.zeros((dr - Y.shape[0], n), dtype=Y.dtype)])
            # warm budget ALWAYS (X0=None included: the first outer
            # iteration never certifies, and the retry below pays the
            # big-block budget exactly when accuracy decides
            # convergence)
            res = solver.solve(ctx, key, X0=warm["X0"], Ypad=Ypad,
                               maxiter=opt.lobpcg_maxiter_warm,
                               tol=opt.cert_inner_tol)
            lam_max = float(res.lam_max)
            cons = max(0.0, -float(res.lam_min)) / (1.0 + lam_max)
            optm = max(0.0, -float(res.neg_vals[0])) / (1.0 + lam_max)
            if cons >= opt.tol and optm < opt.tol:
                # accuracy decides convergence -> big-block host-RR
                rnorm = np.asarray(jax.device_get(
                    jnp.sqrt(jnp.sum(Y * Y, axis=1))))
                p_act = int(np.sum(rnorm > 0.0))
                res = rr_retry.solve(ctx, key, k, X0=res.neg_vecs,
                                     deflate=Y[:p_act],
                                     maxiter=opt.lobpcg_maxiter,
                                     tol=opt.cert_inner_tol,
                                     block_cap=opt.cert_big_block)
            warm["X0"] = res.neg_vecs
            lam_min = float(res.lam_min)
            lam_max = float(res.lam_max)
            dinf = max(0.0, -lam_min) / (1.0 + lam_max)
            import os as _os
            if _os.environ.get("MANISDP_CERT_DEBUG"):
                d = solver.last
                print(f"    [cert] iters={int(d['iters'])} "
                      f"resid_k={float(d['resid']):.3e} "
                      f"scale={float(d['scale']):.3e} "
                      f"lam_min={lam_min:.3e} ritz0="
                      f"{float(res.neg_vals[0]):.3e}", flush=True)
            return (z, float(obj), dinf, int(res.num_neg),
                    np.asarray(jax.device_get(res.neg_vecs)),
                    np.asarray(jax.device_get(res.neg_vals)))

        return cert

    if opt.cert_method in ("rowrr", "devrr") and not use_eigh:
        # (devrr lands here when n <= 3 * block — too small for the
        # fixed-block device program; the host-RR path has no minimum)
        # row-layout LOBPCG + host Rayleigh-Ritz (see ops/eigs_rr.py);
        # S = C - diag(z), applied as rows:  V @ C - V .* z
        from ..ops.eigs_rr import RowCertSolver
        cert32 = opt.cert_pre_dtype in ("float32", "auto")

        def mvr(V, ctx):
            CV = V @ ctx["C"] if dense else ctx["C"].matmat(V)
            return CV - ctx["z"][None, :] * V

        solver = RowCertSolver(mvr, n, mvr if cert32 else None)
        warm = {"X0": None}

        def cert(Y, C, key):
            z, obj = z_obj(Y, C)
            ctx = dict(C=C, z=z)
            X0 = warm["X0"]
            if X0 is None:
                res = solver.solve(ctx, key, k, deflate=Y,
                                   maxiter=opt.lobpcg_maxiter, tol=opt.cert_inner_tol)
            else:
                res = solver.solve(ctx, key, k, X0=X0, deflate=Y,
                                   maxiter=opt.lobpcg_maxiter_warm,
                                   tol=opt.cert_inner_tol)
                lam_max = float(res.lam_max)
                cons = max(0.0, -float(res.lam_min)) / (1.0 + lam_max)
                optm = max(0.0, -float(res.neg_vals[0])) / (1.0 + lam_max)
                if cons >= opt.tol and optm < opt.tol:
                    res = solver.solve(ctx, key, k, X0=res.neg_vecs,
                                       deflate=Y,
                                       maxiter=opt.lobpcg_maxiter,
                                       tol=opt.cert_inner_tol)
            warm["X0"] = res.neg_vecs
            lam_min = float(res.lam_min)
            lam_max = float(res.lam_max)
            dinf = max(0.0, -lam_min) / (1.0 + lam_max)
            return (z, float(obj), dinf, int(res.num_neg),
                    np.asarray(jax.device_get(res.neg_vecs)),
                    np.asarray(jax.device_get(res.neg_vals)))

        return cert

    use32 = opt.cert_pre_dtype == "float32"

    def _lob(maxiter):
        @jax.jit
        def lobpcg_cert(Y, C, z, key, X0):
            def matvec(V):
                CV = C.T @ V if dense else C.matvec_block(V)
                return CV - z[:, None] * V
            matvec32 = None
            if use32:
                cast32 = lambda t: jax.tree_util.tree_map(
                    lambda x: x.astype(jnp.float32)
                    if jnp.issubdtype(x.dtype, jnp.floating) else x, t)
                C32 = cast32(C)
                z32 = z.astype(jnp.float32)

                def matvec32(V):
                    CV = C32.T @ V if dense else C32.matvec_block(V)
                    return CV - z32[:, None] * V
            return lobpcg_certificate(matvec, n, k, key, deflate=Y, X0=X0,
                                      maxiter=maxiter, matvec32=matvec32,
                                      refine_iters=opt.lobpcg_refine)
        return lobpcg_cert

    lob_full = _lob(opt.lobpcg_maxiter)
    lob_warm = _lob(opt.lobpcg_maxiter_warm)
    warm = {"X0": None}

    def cert(Y, C, key):
        z, obj = z_obj(Y, C)
        if use_eigh:
            res = dense_certificate(C - jnp.diag(z), k)
            lam_min = float(res.lam_min)
            lam_max = float(res.lam_max)
            num_neg = int(res.num_neg)
            neg_vecs = np.asarray(jax.device_get(res.neg_vecs))
            neg_vals = np.asarray(jax.device_get(res.neg_vals))
        else:
            X0 = warm["X0"]
            if X0 is None:
                X0 = jax.random.normal(
                    jax.random.fold_in(key, 1), (n, k), dtype=jnp.float64)
                res = lob_full(Y, C, z, key, X0)
            else:
                res = lob_warm(Y, C, z, key, X0)
                lam_max = float(res.lam_max)
                cons = max(0.0, -float(res.lam_min)) / (1.0 + lam_max)
                optm = max(0.0, -float(res.neg_vals[0])) / (1.0 + lam_max)
                if cons >= opt.tol and optm < opt.tol:
                    # accuracy decides convergence -> pay the full budget
                    res = lob_full(Y, C, z, key, res.neg_vecs)
            warm["X0"] = res.neg_vecs
            lam_min = float(res.lam_min)
            lam_max = float(res.lam_max)
            num_neg = int(res.num_neg)
            neg_vecs = np.asarray(jax.device_get(res.neg_vecs))
            neg_vals = np.asarray(jax.device_get(res.neg_vals))
        dinf = max(0.0, -lam_min) / (1.0 + lam_max)
        return z, float(obj), dinf, num_neg, neg_vecs, neg_vals

    return cert


def solve_maxcut_unitdiag(C, options: Optional[SolverOptions] = None,
                          Y0: Optional[np.ndarray] = None,
                          resume: Optional[str] = None,
                          **overrides) -> SDPResult:
    """Solve min <C,X> s.t. diag(X)=1, X>=0 via Burer-Monteiro RTR.

    ``C`` may be a scipy sparse matrix, dense array, or SymCOO.
    ``resume``: path of a checkpoint_every snapshot (this driver's
    outer state is just the factor Y — there are no multipliers).
    """
    if resume:
        from ..utils.checkpoint import resume_kwargs
        Y0 = resume_kwargs(resume).get("Y0", Y0)
    opt = merged_options("maxcut_unitdiag", options, **overrides)
    if not isinstance(C, SymCOO):
        import scipy.sparse as sp
        C = sp.coo_matrix(C)
        # <C, X> depends only on the symmetric part; the RTR cost/grad
        # assume symmetry, so enforce it here.
        C = SymCOO.from_scipy(0.5 * (C + C.T))
    n = C.n
    use_eigh = (opt.eig_method == "eigh") or \
        (opt.eig_method == "auto" and n < opt.eig_switch_n)
    dense = use_eigh or (n <= opt.dense_cost_max_n or
                         n * n <= opt.dense_cost_nnz_factor * C.nnz)
    C_param = C.to_dense() if dense else C
    k_cert = opt.delta + 1

    if opt.verbose:
        print("ManiSDP-JAX (maxcut/unitdiag) is starting...", flush=True)
        print(f"SDP size: n = {n}, m = {n}", flush=True)

    inner_cache = JitCache(
        lambda key: _make_inner(opt, dense, use32=key[1]))
    use32 = opt.inner_dtype == "tcg32"
    mixed = opt.inner_dtype == "mixed"
    if mixed:
        C32 = (C_param.astype(jnp.float32) if dense
               else SymCOO(i=C_param.i, j=C_param.j,
                           v=C_param.v.astype(jnp.float32), n=C_param.n))
    cert_fn = _make_cert(opt, n, k_cert, use_eigh, dense)
    rank = RankController(opt.theta, opt.delta, opt.alpha,
                          nne_floor=True, bucket=opt.p_bucket)
    slow = SlowProgress(period=20, warmup=50)

    key = jax.random.PRNGKey(opt.seed)
    p = opt.p0
    p_pad = bucketed(p, opt.p_bucket)
    typdist = float(np.pi * np.sqrt(n))
    if Y0 is not None:
        Y0 = np.asarray(Y0, dtype=np.float64)
        p = Y0.shape[0]
        p_pad = bucketed(p, opt.p_bucket)
        Y = jnp.asarray(pad_rows(Y0, p_pad))
    else:
        key, sub = jax.random.split(key)
        Y = Oblique.rand(sub, p, n, p_pad)
    U_dir = None

    status = 0
    total_tr = total_hess = fallbacks = 0
    fac_size = []
    history = []
    timers = PhaseTimers()
    t0 = time.time()
    obj = dinf = gradnorm = np.nan
    z_dev = S_last = None
    it = 0

    for it in range(1, opt.max_outer + 1):
        fac_size.append(p)
        solve, solve32, line_search = inner_cache((p_pad, use32))
        with timers.timed("rtr"):
            if U_dir is not None:
                Y = line_search(Y, jnp.asarray(U_dir), C_param)
            # f32 pre-stage: skipped once the previous f64 gradnorm sits
            # at/below the f32 target (below the f32 noise floor the
            # pre-stage burns its budget without progress)
            run32 = mixed and not (np.isfinite(gradnorm) and
                                   gradnorm <= opt.mixed_tolgradnorm)
            if run32:
                res32 = jax.block_until_ready(
                    solve32(Y.astype(jnp.float32), C32, typdist))
                Y = Oblique.renormalize(res32.Y.astype(jnp.float64))
            res = jax.block_until_ready(solve(Y, C_param, typdist))
            Y = res.Y
        gradnorm = float(res.norm_grad)
        total_tr += int(res.iters)
        total_hess += int(res.inner_iters)
        if run32:
            total_tr += int(res32.iters)
            total_hess += int(res32.inner_iters)

        key, sub = jax.random.split(key)
        with timers.timed("cert"):
            z_dev, obj, dinf, num_neg, neg_vecs, neg_vals = cert_fn(
                Y, C_param, sub)

        with timers.timed("rank"):
            r, e, Ul = rank.truncation(Y, p)
        log_iter(opt.verbose, it, obj, dinf=dinf, r=r, p=p, t0=t0)
        history.append(dict(iter=it, obj=obj, dinf=dinf, r=r, p=p,
                            gradnorm=gradnorm))
        timers.log_delta(opt.verbose)
        if dinf < opt.tol:
            if opt.verbose:
                print("Optimality is reached!", flush=True)
            break
        if slow.check(it, dinf):
            if use32:
                # precision fallback mirroring the AL drivers:
                # demote the f32 tCG inner loop to f64 and keep going
                # instead of bailing with status 2
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

        # ---- rank update (host) ----
        Y_host = np.asarray(jax.device_get(Y))
        if r <= p - 1:
            Y_host = (Ul[:, :r].T @ Y_host)
            p = r
        else:
            Y_host = Y_host[:p]
        nne = rank.num_escape(int(num_neg))
        vs = np.asarray(jax.device_get(neg_vecs))[:, :nne]    # (n, nne)
        if opt.line_search:
            U_host = np.vstack([np.zeros((p, n)), vs.T])
            Y_host = np.vstack([Y_host, np.zeros((nne, n))])
        else:
            U_host = None
            Y_host = np.vstack([Y_host, opt.alpha * vs.T])
            Y_host = Y_host / np.sqrt(np.sum(Y_host ** 2, axis=0))
        p = p + nne
        p_pad = max(p_pad, bucketed(p, opt.p_bucket))
        Y = jnp.asarray(pad_rows(Y_host, p_pad))
        U_dir = pad_rows(U_host, p_pad) if U_host is not None else None

        if opt.checkpoint_every and opt.checkpoint_path and \
                it % opt.checkpoint_every == 0:
            from ..utils.checkpoint import save_state
            save_state(opt.checkpoint_path, Y=Y_host[:p], iteration=it)

    else:
        it = opt.max_outer

    if status == 0 and dinf > opt.tol:
        status = 1
        if opt.verbose:
            print("Iteration maximum is reached!", flush=True)

    elapsed = time.time() - t0
    if opt.verbose:
        print(f"ManiSDP-JAX: optimum = {obj:0.8f}, time = {elapsed:0.2f}s",
              flush=True)

    Y_act = np.asarray(jax.device_get(Y))[:p]
    X = Y_act.T @ Y_act
    z = np.asarray(jax.device_get(z_dev)) if z_dev is not None else None
    return SDPResult(X=X, obj=obj, Y=Y_act, z=z, dinf=dinf, eta=dinf,
                     gradnorm=gradnorm, time=elapsed, status=status,
                     iterations=it, fac_size=fac_size, rtr_iters=total_tr,
                     hess_calls=total_hess, precision_fallbacks=fallbacks,
                     history=history,
                     timers=timers.t)
