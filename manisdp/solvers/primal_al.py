"""Primal augmented-Lagrangian drivers for SDPs with affine constraints.

One generic outer loop covering three reference drivers that share the
AL skeleton (SURVEY §2.1) and differ only in manifold, dual shift, and
bookkeeping:

  - unitdiag   (oblique):  min <C,X> s.t. A(X)=b, diag(X)=1, X>=0
                (src/primal/ManiSDP_unitdiag.m)
  - unittrace  (sphere):   min <C,X> s.t. A(X)=b, tr(X)=1, X>=0
                (src/primal/ManiSDP_unittrace.m)
  - general    (euclidean): min <C,X> s.t. A(X)=b, X>=0
                (src/primal/ManiSDP.m)

All per-iteration math is factored: with P the union sparsity pattern
of {C} U {A_k}, the AL cost/grad/hess touch only
  e_P   = <Y[:,i], Y[:,j]> on P          (pair gathers)
  w     = A(YY') via entrywise segments  (never X)
  eS    = values of mat(c + sigma A'w) ON P
and the dual matrix S is eigendecomposed either on host (dense, small
n) or on device via Lanczos+LOBPCG matvecs on the pattern.

Note: constraint matrices A_k and C are assumed symmetric (SeDuMi
semantics; the reference generators emit symmetric entries), which lets
A(vec(Y'U)) use either argument order.
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
from ..manifolds import Euclidean, Oblique, Sphere
from ..ops.eigs import dense_certificate, lobpcg_certificate
from ..ops.sparse import ConstraintOp
from .common import (JitCache, PhaseTimers, RankController, SDPResult,
                     SlowProgress, bucketed, log_iter, make_line_search,
                     pad_rows)


@dataclasses.dataclass(frozen=True)
class ALVariant:
    name: str                  # key into VARIANT_DEFAULTS
    manifold: type
    shift: str                 # "diag" | "trace" | "none"
    nne_floor: bool
    slow_period: int
    slow_warmup: int


VARIANTS = {
    "unitdiag": ALVariant("unitdiag", Oblique, "diag", True, 50, 100),
    "unittrace": ALVariant("unittrace", Sphere, "trace", False, 20, 50),
    "general": ALVariant("general", Euclidean, "none", False, 20, 50),
}


def _make_problem(variant: ALVariant):
    """cost/grad/hess with explicit aux flow.

    params = dict(op=ConstraintOp, y=(m,), sigma=scalar).
    aux    = (Axb, e_P): AL residual and pattern pair-dots.
    gaux   = per-variant gradient byproducts needed by hess.
    """
    M = variant.manifold

    def cost(Y, params):
        op, y, sigma = params["op"], params["y"], params["sigma"]
        e = op.pattern_pair_dots(Y)
        cx = op.dot_pattern(op.c_pattern, e)
        Axb = op.apply_from_e(e) - op.b - y / sigma
        f = cx + 0.5 * sigma * op.dot_res(Axb, Axb)
        return f, (Axb, e)

    def grad(Y, params, aux):
        op, sigma = params["op"], params["sigma"]
        Axb, e = aux
        es = op.es_vals(Axb, sigma)
        eG = 2.0 * op.matmat_pattern(Y, es)
        if variant.shift == "diag":
            YeG = jnp.sum(Y * eG, axis=0)
            G = eG - Y * YeG[None, :]
            return G, (es, YeG)
        elif variant.shift == "trace":
            z = op.dot_pattern(es, e)
            G = eG - 2.0 * z * Y
            return G, (es, z)
        else:
            return eG, (es, None)

    def hess(Y, U, params, aux, gaux):
        op, sigma = params["op"], params["sigma"]
        es, extra = gaux
        w = op.apply_factored(Y, U)                  # A vec(Y'U)
        ayu = op.adjoint_on_pattern(w)               # mat(A'A vec) on P
        eH = 2.0 * op.matmat_pattern(U, es) \
            + 4.0 * sigma * op.matmat_pattern(Y, ayu)
        if variant.shift == "diag":
            YeG = extra
            return eH - Y * jnp.sum(Y * eH, axis=0, keepdims=True) \
                - U * YeG[None, :]
        elif variant.shift == "trace":
            z = extra
            return eH - jnp.sum(eH * Y) * Y - 2.0 * z * U
        else:
            return eH

    def cost_only(Y, params):
        return cost(Y, params)[0]

    return Problem(manifold=M, cost=cost, grad=grad, hess=hess), cost_only


def _make_stats(variant: ALVariant):
    """Post-RTR residuals / multiplier update / dual values, one jit."""

    def stats(Y, op, y, sigma):
        e = op.pattern_pair_dots(Y)
        obj = op.dot_pattern(op.c_pattern, e)
        Ax = op.apply_from_e(e)
        Axb = Ax - op.b
        normb = 1.0 + op.norm_res(op.b)
        pinf = op.norm_res(Axb) / normb
        y_new = y - sigma * Axb
        sv = op.s_vals(y_new)                        # c - A'y on P
        by = op.dot_res(op.b, y_new)
        if variant.shift == "diag":
            z = op.colsum_pattern(sv * e)
            by = by + jnp.sum(z)
        elif variant.shift == "trace":
            z = op.dot_pattern(sv, e)
            by = by + z
        else:
            z = jnp.zeros(())
        gap = jnp.abs(obj - by) / (jnp.abs(by) + jnp.abs(obj) + 1.0)
        return obj, pinf, y_new, sv, z, by, gap

    return stats


def _make_certificate(variant: ALVariant, op_host, n: int, k: int,
                      use_eigh: bool, opt: SolverOptions = None,
                      wrap=jax.jit, sv_unpad=lambda a: a):
    """Eigen-certificate of S = mat(sv) - shift(z).

    ``wrap`` compiles the device LOBPCG path (jax.jit, or a shard_map
    wrapper for the mesh-sharded operator); ``sv_unpad`` strips the
    sharded layout's tail padding before host-side dense assembly.
    """
    if getattr(op_host, "compress_coef", None) is not None and \
            wrap is jax.jit:
        # Expanded-basis operator (ops/symmom.SymMomOp): certify in the
        # COMPRESSED original space — reproduces the reference
        # certificate (ManiSDP_unitdiag.m:65-69: S = mat(c - At*y) -
        # diag(z), z = colsum(X .* eS)) exactly, on the original
        # n_orig basis, with one device f64 eigh.
        dup0 = op_host.dup0

        @jax.jit
        def _orig_cert_mat(Y, sv):
            Yo = Y[:, dup0]
            Xo = Yo.T @ Yo                   # original X (values)
            So = 4.0 * sv[dup0][:, dup0]     # original S (coefficients)
            zo = jnp.sum(So * Xo, axis=0)
            return So - jnp.diag(zo)

        s2 = float(np.sqrt(2.0))

        def cert(Y, op, sv, z, key, gap=np.inf, pinf=np.inf):
            res = dense_certificate(_orig_cert_mat(Y, sv), k)
            # duplicated-basis correspondence: unit expanded lifts are
            # 1/sqrt(2) per copy; scale by sqrt(2) so the escape step
            # matches the reference trajectory (as solve_dual_al does)
            vecs = s2 * op_host.lift_vecs(
                np.asarray(jax.device_get(res.neg_vecs)))
            return (float(res.lam_min), float(res.lam_max),
                    int(res.num_neg), vecs,
                    np.asarray(jax.device_get(res.neg_vals)), None)

        return cert

    if use_eigh:
        pi = np.asarray(op_host.pat.i)
        pj = np.asarray(op_host.pat.j)
        shift = variant.shift

        def _shifted(S, z):
            xp = jnp if isinstance(S, jax.Array) else np
            if shift == "diag":
                return S - xp.diag(z)
            if shift == "trace":
                return S - z * xp.eye(n, dtype=S.dtype)
            return S

        def cert(Y, op, sv, z, key, gap=np.inf, pinf=np.inf):
            if sv.ndim == 2 and wrap is jax.jit:     # dense carrier
                S = _shifted(sv, z)
            else:                                    # pattern values
                S = np.zeros((n, n))
                np.add.at(S, (pi, pj),
                          sv_unpad(np.asarray(jax.device_get(sv))))
                S = _shifted(S, np.asarray(jax.device_get(z)))
            res = dense_certificate(jnp.asarray(S), k)
            return (float(res.lam_min), float(res.lam_max),
                    int(res.num_neg),
                    np.asarray(jax.device_get(res.neg_vecs)),
                    np.asarray(jax.device_get(res.neg_vals)), None)

        return cert

    # size gate: mirror the DeviceCertSolver
    # constructor's n > 3*(k + aug) requirement so small-n problems
    # fall through to the host-RR path instead of raising mid-solve
    _b_cert = max(k, min((n - 1) // 5, 24))
    if opt.cert_method == "devrr" and wrap is jax.jit and n > 3 * _b_cert:
        # Fully device-resident certificate: ONE dispatch per call
        # (ops/eigs_rr.DeviceCertSolver) — the host-RR path below pays
        # ~3 round trips per LOBPCG iteration.  The deflation factor is
        # padded to a stable cert_p_bucket so the program compiles once
        # per run even as the rank bucket grows.
        from ..ops.eigs_rr import DeviceCertSolver

        def mvr(V, ctx):
            SV = ctx["op"].matmat_pattern(V, ctx["sv"])
            if variant.shift == "diag":
                SV = SV - ctx["z"][None, :] * V
            elif variant.shift == "trace":
                SV = SV - ctx["z"] * V
            return SV

        solvers = {}
        warm = {"X0": None}

        def cert(Y, op, sv, z, key, gap=np.inf, pinf=np.inf):
            dr = bucketed(Y.shape[0], opt.cert_p_bucket)
            solver = solvers.get(dr)
            if solver is None:
                solver = DeviceCertSolver(mvr, n, k, deflate_rows=dr)
                solvers[dr] = solver
            Ypad = Y if Y.shape[0] == dr else jnp.concatenate(
                [Y, jnp.zeros((dr - Y.shape[0], n), dtype=Y.dtype)])
            ctx = dict(op=op, sv=sv, z=z)
            # gate on max(cert_cheap_eta, tol) so a loose
            # user tol never terminates off the cheap-budget solve
            far = max(gap, pinf) > max(opt.cert_cheap_eta, opt.tol)
            mi = opt.lobpcg_maxiter_cheap if far \
                else opt.lobpcg_maxiter_warm
            res = solver.solve(ctx, key, X0=warm["X0"], Ypad=Ypad,
                               maxiter=mi, tol=opt.cert_inner_tol)
            if not far:
                lam_max = float(res.lam_max)
                cons = max(0.0, -float(res.lam_min)) / (1.0 + lam_max)
                optm = max(0.0, -float(res.neg_vals[0])) / \
                    (1.0 + lam_max)
                if cons >= opt.tol and optm < opt.tol:
                    # accuracy decides convergence -> full budget
                    res = solver.solve(ctx, key, X0=res.neg_vecs,
                                       Ypad=Ypad,
                                       maxiter=opt.lobpcg_maxiter,
                                       tol=opt.cert_inner_tol)
            warm["X0"] = res.neg_vecs
            return (float(res.lam_min), float(res.lam_max),
                    int(res.num_neg),
                    np.asarray(jax.device_get(res.neg_vecs)),
                    np.asarray(jax.device_get(res.neg_vals)), None)

        return cert

    if opt.cert_method in ("rowrr", "devrr") and wrap is jax.jit:
        # (devrr lands here when n <= 3*(k + aug) — too small for the
        # fixed-block device program; the host-RR path has no minimum)
        # Row-layout LOBPCG with host Rayleigh-Ritz (ops/eigs_rr.py):
        # the certificate's blocks stay (rows, n) like the tCG hot
        # loop (lobpcg_standard works on (n, k) columns).
        # Sharded operators keep the legacy path (their matvecs psum
        # under shard_map, incompatible with the plain-jit solver).
        from ..ops.eigs_rr import RowCertSolver
        cert32 = opt.cert_pre_dtype in ("float32", "auto")

        def mvr(V, ctx):
            SV = ctx["op"].matmat_pattern(V, ctx["sv"])
            if variant.shift == "diag":
                SV = SV - ctx["z"][None, :] * V
            elif variant.shift == "trace":
                SV = SV - ctx["z"] * V
            return SV

        solver = RowCertSolver(mvr, n, mvr if cert32 else None)
        warm = {"X0": None}

        def cert(Y, op, sv, z, key, gap=np.inf, pinf=np.inf):
            ctx = dict(op=op, sv=sv, z=z)
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
                    # accuracy decides convergence -> full budget
                    res = solver.solve(ctx, key, k, X0=res.neg_vecs,
                                       deflate=Y,
                                       maxiter=opt.lobpcg_maxiter,
                                       tol=opt.cert_inner_tol)
            warm["X0"] = res.neg_vecs
            return (float(res.lam_min), float(res.lam_max),
                    int(res.num_neg),
                    np.asarray(jax.device_get(res.neg_vecs)),
                    np.asarray(jax.device_get(res.neg_vals)), None)

        return cert

    use32 = opt.cert_pre_dtype == "float32"

    def _lob(maxiter):
        @wrap
        def lob(Y, op, sv, z, key, X0):
            def matvec(V):
                SV = op.matvec_pattern(V, sv)
                if variant.shift == "diag":
                    SV = SV - z[:, None] * V
                elif variant.shift == "trace":
                    SV = SV - z * V
                return SV
            matvec32 = None
            if use32:
                cast32 = lambda t: jax.tree_util.tree_map(
                    lambda x: x.astype(jnp.float32)
                    if jnp.issubdtype(x.dtype, jnp.floating) else x, t)
                op32 = cast32(op)
                sv32 = sv.astype(jnp.float32)
                z32 = cast32(z)

                def matvec32(V):
                    SV = op32.matvec_pattern(V, sv32)
                    if variant.shift == "diag":
                        SV = SV - z32[:, None] * V
                    elif variant.shift == "trace":
                        SV = SV - z32 * V
                    return SV
            return lobpcg_certificate(matvec, n, k, key, deflate=Y, X0=X0,
                                      maxiter=maxiter, matvec32=matvec32,
                                      refine_iters=opt.lobpcg_refine)
        return lob

    lob_full = _lob(opt.lobpcg_maxiter)
    lob_warm = _lob(opt.lobpcg_maxiter_warm)
    warm = {"X0": None}

    def cert(Y, op, sv, z, key, gap=np.inf, pinf=np.inf):
        X0 = warm["X0"]
        if X0 is None:
            X0 = jax.random.normal(jax.random.fold_in(key, 1), (n, k),
                                   dtype=jnp.float64)
            res = lob_full(Y, op, sv, z, key, X0)
        else:
            res = lob_warm(Y, op, sv, z, key, X0)
            lam_max = float(res.lam_max)
            cons = max(0.0, -float(res.lam_min)) / (1.0 + lam_max)
            optm = max(0.0, -float(res.neg_vals[0])) / (1.0 + lam_max)
            if cons >= opt.tol and optm < opt.tol:
                # accuracy decides convergence -> pay the full budget
                res = lob_full(Y, op, sv, z, key, res.neg_vecs)
        warm["X0"] = res.neg_vecs
        return (float(res.lam_min), float(res.lam_max), int(res.num_neg),
                np.asarray(jax.device_get(res.neg_vecs)),
                np.asarray(jax.device_get(res.neg_vals)), None)

    return cert


def _device_rank_rebuild(cache, variant, opt, k_cert, Y, UlT, vsT,
                         r, nne):
    """Jitted truncate-and-escape-append: Y_new = UlT @ Y with the
    (<= k_cert) escape rows landed at row offset r via a masked roll
    (wrap-around rows are zeros, so no dynamic-slice clipping hazard).
    Returns (Y_new, escape-direction buffer)."""
    p_pad_new, p_pad_old = UlT.shape
    n = Y.shape[1]
    k_rows = int(np.shape(vsT)[0])      # min(k_cert, n) from the cert
    key = (p_pad_new, p_pad_old, k_rows, bool(opt.line_search))
    fn = cache.get(key)
    if fn is None:
        ls = bool(opt.line_search)
        manifold = variant.manifold
        kk = min(k_rows, p_pad_new)

        @jax.jit
        def fn(Y, UlT, vsT, r, nne, alpha):
            Z = UlT @ Y
            ki = jax.lax.broadcasted_iota(jnp.int32, (kk, 1), 0)
            V = jnp.where(ki < nne, vsT[:kk], 0.0)
            Vp = jnp.zeros((p_pad_new, n), dtype=Y.dtype).at[:kk].set(V)
            Vr = jnp.roll(Vp, r, axis=0)
            if ls:
                return Z, Vr
            Yn = Z + alpha * Vr
            if manifold is Oblique:
                Yn = Yn / jnp.sqrt(jnp.maximum(
                    jnp.sum(Yn * Yn, axis=0, keepdims=True), 1e-30))
            elif manifold is Sphere:
                Yn = Yn / jnp.maximum(jnp.linalg.norm(Yn), 1e-30)
            return Yn, Vr

        cache[key] = fn
    return fn(Y, jnp.asarray(UlT), jnp.asarray(vsT, dtype=jnp.float64),
              jnp.int32(r), jnp.int32(nne), jnp.float64(opt.alpha))


# Cross-solve cache of jitted solver/stats closures (NOTES r5 item 3);
# see the factory in solve_primal_al for the reuse contract.
_XSOLVE_CACHE: dict = {}


def solve_primal_al(variant_name: str, op: ConstraintOp,
                    options: Optional[SolverOptions] = None,
                    Y0: Optional[np.ndarray] = None,
                    y0: Optional[np.ndarray] = None,
                    mesh=None,
                    **overrides) -> SDPResult:
    variant = VARIANTS[variant_name]
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

    # ---- mesh sharding (SURVEY §2.7: model-axis tensor parallelism) ----
    # With a jax.sharding.Mesh, the sparse operator is partitioned by
    # pattern id over the 'model' axis and every compiled function
    # (RTR solve, stats, line search, LOBPCG certificate) runs under
    # shard_map; reductions psum over the mesh axis.  Semantics are
    # identical to the single-device path (equivalence-tested on the
    # virtual mesh).
    sharded = mesh is not None
    if sharded:
        from jax.sharding import PartitionSpec as _P
        from ..parallel.sharded_ops import ShardedConstraintOp
        # Shard over the 'model' axis (the last axis when no axis is
        # literally named 'model') and REPLICATE over any other mesh
        # axes: distributed.make_host_mesh's recommended 2-D
        # (host, model) mesh composes directly.
        # The operator is built with exactly mesh.shape[axis] slices,
        # every PartitionSpec mentions only ``axis``, and both
        # NamedSharding device_put and shard_map replicate over the
        # unmentioned axes — devices.size slices can never be folded
        # onto one axis.
        axis = "model" if "model" in mesh.axis_names \
            else mesh.axis_names[-1]
        sop_host = ShardedConstraintOp.build(op, mesh.shape[axis], axis)
        op_dev = jax.device_put(sop_host, sop_host.shardings(mesh))
        op_specs = sop_host.specs()
        param_specs = dict(op=op_specs, y=_P(), sigma=_P())

        def shard_wrap(fn, in_specs, out_specs=_P()):
            return jax.jit(jax.shard_map(
                fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                check_vma=False))

        sv_spec = _P(axis)
        sv_unpad = lambda a: a[:op.pat.nnz]
    else:
        # operator specialization ladder (see config.al_op_mode):
        #   1. entrywise-sample structure (matrix-completion class) ->
        #      EntrywiseConstraintOp: dense masked elementwise +
        #      matmuls, no gather/scatter at all;
        #   2. dense matmul carriers for moderate n;
        #   3. factored gather/segment path (scales, shards).
        op_dev = None
        if not isinstance(op, ConstraintOp):
            # dense-tensor operator (ops/symmom.SymMomOp): already the
            # specialized form — no ladder
            op_dev = op
        elif opt.al_op_mode in ("auto", "entrywise") and \
                n <= opt.entrywise_al_max_n:
            from ..ops.sparse import EntrywiseConstraintOp
            op_dev = EntrywiseConstraintOp.detect(op)
            if op_dev is None and opt.al_op_mode == "entrywise":
                raise ValueError(
                    "al_op_mode='entrywise' but the constraint set is "
                    "not entrywise (single-entry / symmetric-pair)")
        if op_dev is None:
            use_dense_op = opt.al_op_mode == "dense" or (
                opt.al_op_mode == "auto" and n <= opt.dense_al_max_n)
            op_dev = op.to_dense_op() if use_dense_op else op
        sv_unpad = lambda a: a

    problem, cost_only = _make_problem(variant)
    M = variant.manifold
    def budget(tier, use32):
        kw = dict(tolgradnorm=opt.tolgradnorm,
                  tcg_dtype="float32" if use32 else None)
        if tier == 0:
            return TROptions(maxiter=opt.tr_maxiter,
                             maxinner=opt.tr_maxinner, **kw)
        return TROptions(maxiter=max(opt.boost_tr_maxiter, opt.tr_maxiter),
                         maxinner=max(opt.boost_tr_maxinner,
                                      opt.tr_maxinner), **kw)

    def factory(key):
        _, tier, u32 = key
        # Cross-SOLVE closure reuse (same scheme as dual_al):
        # problem/stats closures capture only the variant (op and
        # multipliers travel through ``params``), so the jitted
        # callables are reusable across solve calls — the warm run
        # then hits the in-process executable cache instead of
        # re-tracing and re-loading programs from the persistent
        # compile cache.  Gated off under shard_map (mesh-specific
        # wraps).
        ck = None
        if not sharded:
            import dataclasses as _dc
            import os as _os
            ck = (variant_name, _dc.astuple(budget(tier, u32)),
                  opt.inner_dtype, float(opt.mixed_tolgradnorm),
                  _os.environ.get("MANISDP_LS_TAIL"))
            hit = _XSOLVE_CACHE.get(ck)
            if hit is not None:
                return hit
        base = make_trustregions(problem, budget(tier, u32))
        solve32 = None
        if sharded:
            solve = shard_wrap(base, (_P(), param_specs, _P()))
            ls = make_line_search(
                cost_only, M.renormalize,
                wrap=lambda f: shard_wrap(f, (_P(), _P(), param_specs)))
        else:
            solve = jax.jit(base)
            ls = make_line_search(
                cost_only, M.renormalize,
                ls_dtype="float32" if opt.inner_dtype == "tcg32"
                else None)
        if opt.inner_dtype == "mixed":
            t = budget(tier, False)
            tr32 = TROptions(maxiter=t.maxiter, maxinner=t.maxinner,
                             tolgradnorm=max(opt.mixed_tolgradnorm,
                                             t.tolgradnorm))
            base32 = make_trustregions(problem, tr32)
            solve32 = shard_wrap(base32, (_P(), param_specs, _P())) \
                if sharded else jax.jit(base32)
        out = (solve, solve32, ls)
        if ck is not None:
            _XSOLVE_CACHE[ck] = out
        return out

    cache = JitCache(factory)
    rebuild_cache = {}
    # f32 copy of the constraint operator for the mixed pre-stage
    # (index arrays shared; only float leaves are cast)
    op32 = None
    if opt.inner_dtype == "mixed":
        op32 = jax.tree_util.tree_map(
            lambda x: x.astype(jnp.float32)
            if jnp.issubdtype(x.dtype, jnp.floating) else x, op_dev)
    if sharded:
        stats_raw = _make_stats(variant)
        stats_fn = shard_wrap(
            stats_raw, (_P(), op_specs, _P(), _P()),
            out_specs=(_P(), _P(), _P(), sv_spec, _P(), _P(), _P()))
        cert_wrap = lambda f: shard_wrap(
            f, (_P(), op_specs, sv_spec, _P(), _P(), _P()))
        cert_fn = _make_certificate(variant, op, n, k_cert, use_eigh, opt,
                                    wrap=cert_wrap, sv_unpad=sv_unpad)
    else:
        # reuse the jitted stats program across solves (data-free)
        sk = ("stats", variant_name)
        stats_fn = _XSOLVE_CACHE.get(sk)
        if stats_fn is None:
            stats_fn = jax.jit(_make_stats(variant))
            _XSOLVE_CACHE[sk] = stats_fn
        cert_fn = _make_certificate(variant, op, n, k_cert, use_eigh, opt)
    rank = RankController(opt.theta, opt.delta, opt.alpha,
                          nne_floor=variant.nne_floor, bucket=opt.p_bucket)
    slow = SlowProgress(variant.slow_period, variant.slow_warmup)

    key = jax.random.PRNGKey(opt.seed)
    p = opt.p0 if opt.p0 > 0 else max(int(np.ceil(np.log(max(m, 2)))), 1)
    p_pad = bucketed(p, opt.p_bucket)
    if Y0 is not None:
        Y0 = np.asarray(Y0, dtype=np.float64)
        if Y0.shape[1] != n:      # accept reference (n, p) layout too
            Y0 = Y0.T
        p = Y0.shape[0]
        p_pad = max(p_pad, bucketed(p, opt.p_bucket))
        Y = jnp.asarray(pad_rows(Y0, p_pad))
    else:
        key, sub = jax.random.split(key)
        Y = M.rand(sub, p, n, p_pad)
    # expanded-basis operators (ops/symmom.SymMomOp) supply a
    # symmetrize hook: init, post-solve and rebuilt factors are
    # projected onto the duplicate-symmetric subspace, where the
    # expanded dynamics reproduce the reference trajectory (see
    # ops/symdual.py for the original analysis)
    symmetrize = getattr(op_dev, "symmetrize", None)
    if symmetrize is not None:
        Y = symmetrize(Y)
    U_dir = None

    y = op_dev.res_zeros() if y0 is None else op_dev.res_from_mvec(y0)
    sigma = opt.sigma0
    status = 0
    total_tr = total_hess = fallbacks = 0
    fac_size, history = [], []
    t0 = time.time()
    obj = gap = pinf = dinf = gradnorm = eta = np.nan
    sv_dev = z_dev = y_dev = None
    it = 0
    tier = 0
    use32 = opt.inner_dtype == "tcg32"
    frozen = 0          # consecutive endgame iterations with frozen sigma

    timers = PhaseTimers()
    for it in range(1, opt.max_outer + 1):
        fac_size.append(p)
        solve, solve32, line_search = cache((p_pad, tier, use32))
        params = dict(op=op_dev, y=y, sigma=jnp.float64(sigma))
        with timers.timed("rtr"):
            if U_dir is not None:
                Y = line_search(Y, jnp.asarray(U_dir), params)
            typdist = float(M.typicaldist(p, n))
            # f32 pre-stage: skipped in the endgame tier and whenever the
            # previous f64 gradnorm already sits at/below the f32 target
            # (below the f32 noise floor the pre-stage burns its whole
            # budget without progress)
            if solve32 is not None and tier == 0 and not \
                    (np.isfinite(gradnorm) and
                     gradnorm <= opt.mixed_tolgradnorm):
                params32 = dict(op=op32, y=y.astype(jnp.float32),
                                sigma=jnp.float32(sigma))
                res32 = jax.block_until_ready(
                    solve32(Y.astype(jnp.float32), params32, typdist))
                Y = M.renormalize(res32.Y.astype(jnp.float64))
                total_tr += int(res32.iters)
                total_hess += int(res32.inner_iters)
            res = jax.block_until_ready(solve(Y, params, typdist))
            Y = res.Y
            if symmetrize is not None:
                Y = symmetrize(Y)
        gradnorm = float(res.norm_grad)
        total_tr += int(res.iters)
        total_hess += int(res.inner_iters)

        with timers.timed("stats"):
            obj_d, pinf_d, y, sv_dev, z_dev, by_d, gap_d = stats_fn(
                Y, op_dev, y, jnp.float64(sigma))
            obj, pinf, gap = float(obj_d), float(pinf_d), float(gap_d)
        y_dev = y

        with timers.timed("cert"):
            key, sub = jax.random.split(key)
            lam_min, lam_max, num_neg, neg_vecs, neg_vals, S_dense = cert_fn(
                Y, op_dev, sv_dev, z_dev, sub, gap=gap, pinf=pinf)
        dinf = max(0.0, -lam_min) / (1.0 + lam_max)

        with timers.timed("rank"):
            r, e_sv, Ul = rank.truncation(Y, p)
        log_iter(opt.verbose, it, obj, gap=gap, pinf=pinf, dinf=dinf,
                 gradnorm=gradnorm, r=r, p=p, sigma=sigma, t0=t0)
        history.append(dict(iter=it, obj=obj, gap=gap, pinf=pinf, dinf=dinf,
                            gradnorm=gradnorm, r=r, p=p, sigma=sigma))
        timers.log_delta(opt.verbose)
        eta = max(gap, pinf, dinf)
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

        # ---- rank update ----
        # no escape when the certificate already passes: num_neg
        # counts RAW negative eigenvalues, so a -1e-18 sign-noise
        # eigenvalue at a converged point appends a junk direction and
        # the endgame limit-cycles (observed on control1: dinf
        # oscillating 1e-16 <-> 1e-3 for 100+ outers while gap/pinf
        # sat at 1e-4; the reference has the same raw-sign rule but
        # cannot run the K.l classes at all)
        nne = rank.num_escape(num_neg) if dinf > opt.tol else 0
        p_new = (r if r <= p - 1 else p) + nne
        if not sharded and variant.manifold is not Sphere:
            # fully on-device (no device_get(Y) -> numpy vstack ->
            # re-upload round trip per outer iteration).  Truncation
            # is a tiny host-masked (p_pad_new, p_pad_old) matmul; the
            # escape rows land via a masked
            # roll, so no dynamic-slice clipping can misplace them.
            # The SPHERE (unittrace) family keeps the host path: its
            # hair-trigger sigma controller (tau1 = 1e-5) makes the
            # trajectory chaotic at the level of device-vs-numpy f64
            # rounding (hamming theta limit-cycles under the device
            # rebuild while the bit-identical host math converges), and
            # its instances are small enough that the host hop is noise.
            p_pad_new = max(p_pad, bucketed(p_new, opt.p_bucket))
            UlT = np.zeros((p_pad_new, p_pad), dtype=np.float64)
            if r <= p - 1:
                UlT[:r] = Ul[:, :r].T
                p = r
            else:
                UlT[:p, :p] = np.eye(p)
            Y, U_dir = _device_rank_rebuild(
                rebuild_cache, variant, opt, k_cert,
                Y, UlT, jnp.asarray(neg_vecs).T, p, nne)
            if not opt.line_search:
                U_dir = None
            p = p + nne
            p_pad = p_pad_new
        else:
            Y_host = np.asarray(jax.device_get(Y))
            if r <= p - 1:
                Y_host = Ul[:, :r].T @ Y_host
                p = r
            else:
                Y_host = Y_host[:p]
            vs = np.asarray(neg_vecs[:, :nne])
            if opt.line_search:
                U_host = np.vstack([np.zeros((p, n)), vs.T])
                Y_host = np.vstack([Y_host, np.zeros((nne, n))])
            else:
                U_host = None
                Y_host = np.vstack([Y_host, opt.alpha * vs.T])
                if variant.manifold is Oblique:
                    Y_host = Y_host / np.sqrt(np.sum(Y_host ** 2, axis=0))
                elif variant.manifold is Sphere:
                    Y_host = Y_host / np.linalg.norm(Y_host)
            p = p + nne
            p_pad = max(p_pad, bucketed(p, opt.p_bucket))
            Y = jnp.asarray(pad_rows(Y_host, p_pad))
            U_dir = pad_rows(U_host, p_pad) if U_host is not None else None
        if symmetrize is not None:
            # renorm=False: the reference only renormalizes the STEPPED
            # point (see solve_dual_al's rebuild notes)
            Y = symmetrize(Y, renorm=False)
            if U_dir is not None:
                U_dir = symmetrize(U_dir, renorm=False)

        # ---- sigma schedule ----
        if pinf < opt.tau1 * gradnorm:
            sigma = max(sigma / opt.gama, opt.sigma_min)
            frozen = 0
        elif pinf > opt.tau2 * gradnorm:
            sigma = min(sigma * opt.gama, opt.sigma_max)
            frozen = 0
        else:
            # endgame boost: sigma frozen with dinf the DOMINANT
            # blocker -> the subproblem is under-resolved; escalate
            # the TR budget.  The gate is "near convergence AND dinf
            # clearly dominates", not an absolute 10*tol box: theta1
            # at the 1e-8 contract hovers at gap ~2e-7 / pinf ~5e-7
            # with dinf ~3e-6 and sigma frozen — the old 10*tol gate
            # (1e-7) never opened, no deep solve ever fired, and
            # SlowProgress killed the run at eta 2.8e-6.
            near = max(gap, pinf) <= max(1e-6, 10 * opt.tol)
            if (opt.endgame_boost and tier == 0 and near and
                    dinf > opt.tol and dinf > 2.0 * max(gap, pinf)):
                frozen += 1
                if frozen >= opt.boost_after:
                    tier = 1
            else:
                frozen = 0

        # checkpoint AFTER the sigma update so resuming with
        # sigma0=st["sigma"] continues the exact trajectory (the
        # documented SDPResult.sigma is also post-update)
        if opt.checkpoint_every and opt.checkpoint_path and \
                it % opt.checkpoint_every == 0:
            from ..utils.checkpoint import save_state
            save_state(opt.checkpoint_path,
                       Y=np.asarray(jax.device_get(Y))[:p],
                       y=op_dev.res_to_mvec(y), sigma=sigma,
                       tier=tier, iteration=it)
    else:
        it = opt.max_outer

    if status == 0 and eta > opt.tol:
        status = 1
        if opt.verbose:
            print("Iteration maximum is reached!", flush=True)

    elapsed = time.time() - t0
    if opt.verbose:
        print(f"ManiSDP-JAX: optimum = {obj:0.8f}, time = {elapsed:0.2f}s",
              flush=True)

    Y_act = np.asarray(jax.device_get(Y))[:p]
    X = Y_act.T @ Y_act
    S_host = None
    if sv_dev is not None:
        sv_h = sv_unpad(np.asarray(jax.device_get(sv_dev)))
        if sv_h.ndim == 2:               # dense-carrier operator
            S_host = sv_h.copy()
        else:
            S_host = np.zeros((n, n))
            np.add.at(S_host, (np.asarray(op.pat.i), np.asarray(op.pat.j)),
                      sv_h)
        if variant.shift == "diag":
            S_host[np.arange(n), np.arange(n)] -= np.asarray(
                jax.device_get(z_dev))
        elif variant.shift == "trace":
            S_host[np.arange(n), np.arange(n)] -= float(z_dev)
    return SDPResult(
        X=X, obj=obj, Y=Y_act,
        y=op_dev.res_to_mvec(y_dev) if y_dev is not None else None,
        S=S_host,
        z=np.asarray(jax.device_get(z_dev)) if z_dev is not None else None,
        gap=gap, pinf=pinf, dinf=dinf, eta=eta, gradnorm=gradnorm,
        time=elapsed, status=status, iterations=it, fac_size=fac_size,
        rtr_iters=total_tr, hess_calls=total_hess,
        precision_fallbacks=fallbacks, history=history,
        timers=timers.t, sigma=sigma, tier=tier)
