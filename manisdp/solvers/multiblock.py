"""Primal multiblock driver: X in S+^{n_1 x ... x n_t}, first ``nob``
blocks unit-diagonal (JAX equivalent of src/primal/ManiSDP_multiblock.m).

Design (replaces the reference's per-block MATLAB loops and
the 7 C MEX kernels): all block factors live in ONE flat (p_max, N)
array over the concatenated block columns (N = sum n_i), with
  - a per-column oblique mask driving the product-manifold geometry
    (manifolds/product.py) — one fused elementwise pass instead of cell loops;
  - the constraint operator on the unified column space
    (ConstraintOp.build_multiblock) — X stays block-diagonal because
    constraints never couple columns across blocks;
  - per-block rank control on host: each block occupies rows
    0..p_i-1 of its column group, zero-padded above.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SolverOptions, merged_options
from ..core import Problem, TROptions, make_trustregions
from ..manifolds.product import MaskedProduct
from ..ops.sparse import ConstraintOp
from .common import (JitCache, PhaseTimers, SDPResult, SlowProgress,
                     bucketed, log_iter, make_line_search,
                     pad_rows)


def _make_problem(M: MaskedProduct):
    """Masked variant of the unit-diagonal AL callbacks
    (ManiSDP_multiblock.m:207-249): Euclidean-block columns skip the
    oblique projection/shift via the 0/1 column mask."""

    def cost(Y, params):
        op, y, sigma = params["op"], params["y"], params["sigma"]
        e = op.pattern_pair_dots(Y)
        cx = jnp.dot(op.c_pattern, e)
        Axb = op.apply_from_e(e) - op.b - y / sigma
        return cx + 0.5 * sigma * jnp.dot(Axb, Axb), (Axb, e)

    def grad(Y, params, aux):
        op, sigma = params["op"], params["sigma"]
        Axb, _ = aux
        es = op.es_vals(Axb, sigma)
        eG = 2.0 * op.matmat_pattern(Y, es)
        YeG = jnp.sum(Y * eG, axis=0) * M.mask.astype(Y.dtype)
        return eG - Y * YeG[None, :], (es, YeG)

    def hess(Y, U, params, aux, gaux):
        op, sigma = params["op"], params["sigma"]
        es, YeG = gaux
        w = op.apply_factored(Y, U)
        ayu = op.adjoint_on_pattern(w)
        eH = 2.0 * op.matmat_pattern(U, es) \
            + 4.0 * sigma * op.matmat_pattern(Y, ayu)
        return eH - Y * (jnp.sum(Y * eH, axis=0)
                         * M.mask.astype(Y.dtype))[None, :] \
            - U * YeG[None, :]

    def cost_only(Y, params):
        return cost(Y, params)[0]

    return Problem(manifold=M, cost=cost, grad=grad, hess=hess), cost_only


def solve_multiblock(At, b, c, ns: Sequence[int], nob: int,
                     options: Optional[SolverOptions] = None,
                     Y0: Optional[np.ndarray] = None,
                     y0: Optional[np.ndarray] = None,
                     ps0: Optional[Sequence[int]] = None,
                     resume: Optional[str] = None,
                     **overrides) -> SDPResult:
    """SeDuMi multiblock input: At (sum n_i^2, m), K.s = ns, K.nob = nob.

    ``Y0``/``y0``/``ps0`` warm-start the flat factor, multipliers and
    per-block ranks; ``resume`` loads all of them (plus sigma) from a
    checkpoint_every snapshot."""
    if resume:
        from ..utils.checkpoint import resume_kwargs
        rk = resume_kwargs(resume)
        Y0 = rk.get("Y0", Y0)
        y0 = rk.get("y0", y0)
        ps0 = rk.get("ps0", ps0)
        if "sigma0" in rk:
            overrides.setdefault("sigma0", rk["sigma0"])
    opt = merged_options("multiblock", options, **overrides)
    ns = [int(x) for x in ns]
    nb = len(ns)
    op = At if isinstance(At, ConstraintOp) else \
        ConstraintOp.build_multiblock(At, b, c, ns)
    N, m = op.n, op.m
    off = np.concatenate([[0], np.cumsum(ns)]).astype(int)

    mask_np = np.zeros(N)
    for bidx in range(nob):
        mask_np[off[bidx]:off[bidx + 1]] = 1.0
    M = MaskedProduct(mask_np)

    if opt.verbose:
        print("ManiSDP-JAX (multiblock) is starting...", flush=True)
        print(f"SDP size: n = {max(ns)}, m = {m}", flush=True)

    problem, cost_only = _make_problem(M)
    # Tiered TR budgets; tier 1 is the endgame escalation engaged when
    # the sigma controller freezes with dinf the only blocking residual
    # (see primal_al.py / NOTES.md theta-class analysis).
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
        solve = jax.jit(make_trustregions(problem, budget(tier, u32)))
        ls = make_line_search(
            cost_only, M.renormalize,
            ls_dtype="float32" if opt.inner_dtype == "tcg32" else None)
        solve32 = None
        if opt.inner_dtype == "mixed":
            t = budget(tier, False)
            tr32 = TROptions(maxiter=t.maxiter, maxinner=t.maxinner,
                             tolgradnorm=max(opt.mixed_tolgradnorm,
                                             t.tolgradnorm))
            solve32 = jax.jit(make_trustregions(problem, tr32))
        return solve, solve32, ls

    cache = JitCache(factory)
    op32 = None
    if opt.inner_dtype == "mixed":
        op32 = jax.tree_util.tree_map(
            lambda x: x.astype(jnp.float32)
            if jnp.issubdtype(x.dtype, jnp.floating) else x, op)

    @jax.jit
    def stats(Y, y, sigma):
        e = op.pattern_pair_dots(Y)
        obj = jnp.dot(op.pat.v, e)
        Axb = op.apply_from_e(e) - op.b
        pinf = jnp.linalg.norm(Axb) / (1.0 + jnp.linalg.norm(op.b))
        y_new = y - sigma * Axb
        sv = op.s_vals(y_new)
        z = jax.ops.segment_sum(sv * e, op.pat.j, num_segments=N,
                                indices_are_sorted=True) * M.mask
        by = jnp.dot(op.b, y_new) + jnp.sum(z)
        gap = jnp.abs(obj - by) / (jnp.abs(by) + jnp.abs(obj) + 1.0)
        return obj, pinf, y_new, sv, z, gap

    pat_i = np.asarray(op.pat.i)
    pat_j = np.asarray(op.pat.j)

    def block_certs(sv_dev, z_dev):
        """Per-block host eigendecomposition of S (blocks are small in
        the sparse-POP workloads this driver targets)."""
        sv_h = np.asarray(jax.device_get(sv_dev))
        z_h = np.asarray(jax.device_get(z_dev))
        S = np.zeros((N, N))
        np.add.at(S, (pat_i, pat_j), sv_h)
        S[np.arange(N), np.arange(N)] -= z_h
        out = []
        for bidx in range(nb):
            sl = slice(off[bidx], off[bidx + 1])
            vals, vecs = np.linalg.eigh(S[sl, sl])
            out.append((vals, vecs))
        dinf = max(max(0.0, -v[0]) / (1.0 + abs(v[-1])) for v, _ in out)
        return out, dinf, S

    # per-block rank state
    p0 = opt.p0 if np.ndim(opt.p0) else [int(opt.p0)] * nb
    ps: List[int] = [ns[i] if ns[i] < opt.min_facsize else int(p0[i])
                     for i in range(nb)]
    if ps0 is not None:
        ps = [int(x) for x in ps0]
    p_pad = bucketed(max(ps), opt.p_bucket)

    key = jax.random.PRNGKey(opt.seed)
    key, sub = jax.random.split(key)
    if Y0 is not None:
        Y0 = np.asarray(Y0, dtype=np.float64)
        p_pad = max(p_pad, bucketed(Y0.shape[0], opt.p_bucket))
        Y_host = pad_rows(Y0, p_pad)
    else:
        Y_host = np.zeros((p_pad, N))
        rnd = np.asarray(jax.device_get(
            jax.random.normal(sub, (p_pad, N), dtype=jnp.float64)))
        for bidx in range(nb):
            sl = slice(off[bidx], off[bidx + 1])
            Yb = rnd[:ps[bidx], sl]
            if bidx < nob:
                Yb = Yb / np.sqrt(np.sum(Yb ** 2, axis=0))
            Y_host[:ps[bidx], sl] = Yb
    Y = jnp.asarray(Y_host)
    U_dir = None

    y = jnp.zeros(m) if y0 is None else jnp.asarray(
        np.asarray(y0, dtype=np.float64).ravel())
    sigma = opt.sigma0
    slow = SlowProgress(50, 100)
    status = 0
    total_tr = total_hess = 0
    fac_size, history = [], []
    t0 = time.time()
    obj = gap = pinf = dinf = gradnorm = eta = np.nan
    sv_dev = z_dev = S_host = None
    it = 0
    tier = 0
    use32 = opt.inner_dtype == "tcg32"
    frozen = 0          # consecutive endgame iterations with frozen sigma

    timers = PhaseTimers()
    for it in range(1, opt.max_outer + 1):
        fac_size.append(max(ps))
        solve, solve32, line_search = cache((p_pad, tier, use32))
        params = dict(op=op, y=y, sigma=jnp.float64(sigma))
        with timers.timed("rtr"):
            if U_dir is not None:
                Y = line_search(Y, jnp.asarray(U_dir), params)
            typdist = MaskedProduct.typicaldist(ns, ps, nob)
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
        gradnorm = float(res.norm_grad)
        total_tr += int(res.iters)
        total_hess += int(res.inner_iters)

        with timers.timed("stats"):
            obj_d, pinf_d, y, sv_dev, z_dev, gap_d = stats(
                Y, y, jnp.float64(sigma))
            obj, pinf, gap = float(obj_d), float(pinf_d), float(gap_d)
        with timers.timed("cert"):
            certs, dinf, S_host = block_certs(sv_dev, z_dev)

        log_iter(opt.verbose, it, obj, gap=gap, pinf=pinf, dinf=dinf,
                 gradnorm=gradnorm, p=max(ps), sigma=sigma, t0=t0)
        history.append(dict(iter=it, obj=obj, gap=gap, pinf=pinf, dinf=dinf,
                            gradnorm=gradnorm, p=max(ps), sigma=sigma))
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
                slow.prev = None
                if opt.verbose:
                    print("Slow progress under tcg32 -> f64 inner "
                          "fallback", flush=True)
            else:
                status = 2
                if opt.verbose:
                    print("Slow progress!", flush=True)
                break

        # ---- per-block rank update (ManiSDP_multiblock.m:112-151) ----
        Y_host = np.array(jax.device_get(Y))       # mutable copy
        U_host = np.zeros_like(Y_host) if opt.line_search else None
        for bidx in range(nb):
            if ns[bidx] < opt.min_facsize:
                continue
            sl = slice(off[bidx], off[bidx + 1])
            pb = ps[bidx]
            if pb > 1:
                Yb = Y_host[:, sl]
                G = Yb @ Yb.T
                wv, V = np.linalg.eigh(G)
                wv = np.maximum(wv, 0.0)
                ordr = np.argsort(wv)[::-1][:pb]
                e_sv = np.sqrt(wv[ordr])
                r = int(np.sum(e_sv >= opt.theta * e_sv[0]))
                r = max(r, 1)
                if r < pb:
                    Ynew = V[:, ordr[:r]].T @ Yb
                    Y_host[:, sl] = 0.0
                    Y_host[:r, sl] = Ynew
                    ps[bidx] = r
                    pb = r
            vals, vecs = certs[bidx]
            if dinf <= opt.tol:
                # no escape when the certificate already passes: raw
                # sign counting appends junk directions off -1e-18
                # noise eigenvalues at a converged point and the
                # endgame limit-cycles (see primal_al.py rank update;
                # observed on control1)
                nne = 0
            elif bidx < nob:
                nne = max(min(int(np.sum(vals < 0)), opt.delta), 1)
            else:
                nne = min(int(np.sum(vals < 0)), opt.delta)
            if pb + nne > ns[bidx]:
                nne = 0
            if nne > 0:
                vs = vecs[:, :nne]
                grow = max(pb + nne - Y_host.shape[0], 0)
                if grow:
                    Y_host = np.vstack([Y_host, np.zeros((grow, N))])
                    if U_host is not None:
                        U_host = np.vstack([U_host, np.zeros((grow, N))])
                if opt.line_search:
                    U_host[pb:pb + nne, sl] = vs.T
                else:
                    Y_host[pb:pb + nne, sl] = opt.alpha * vs.T
                    if bidx < nob:
                        Yb = Y_host[:, sl]
                        Y_host[:, sl] = Yb / np.sqrt(
                            np.sum(Yb ** 2, axis=0))
                ps[bidx] = pb + nne
        p_act = max(max(ps), 1)
        p_pad = max(p_pad, bucketed(p_act, opt.p_bucket))
        Y = jnp.asarray(pad_rows(Y_host[:p_act], p_pad))
        U_dir = pad_rows(U_host[:p_act], p_pad) if U_host is not None \
            else None

        if pinf < opt.tau1 * gradnorm:
            sigma = max(sigma / opt.gama, opt.sigma_min)
            frozen = 0
        elif pinf > opt.tau2 * gradnorm:
            sigma = min(sigma * opt.gama, opt.sigma_max)
            frozen = 0
        else:
            # endgame boost: sigma frozen with only dinf above tol ->
            # escalate the TR budget (primal_al.py mechanism)
            if (opt.endgame_boost and tier == 0 and
                    gap <= 10 * opt.tol and pinf <= 10 * opt.tol and
                    dinf > opt.tol):
                frozen += 1
                if frozen >= opt.boost_after:
                    tier = 1
            else:
                frozen = 0

        # checkpoint AFTER the sigma update so resume continues the
        # exact trajectory (see primal_al.py)
        if opt.checkpoint_every and opt.checkpoint_path and \
                it % opt.checkpoint_every == 0:
            from ..utils.checkpoint import save_state
            save_state(opt.checkpoint_path, Y=Y_host[:p_act],
                       y=np.asarray(jax.device_get(y)), sigma=sigma,
                       tier=tier, iteration=it,
                       extra=dict(ps=np.asarray(ps)))
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

    Y_final = np.asarray(jax.device_get(Y))
    X_blocks = []
    for bidx in range(nb):
        sl = slice(off[bidx], off[bidx + 1])
        Yb = Y_final[:, sl]
        X_blocks.append(Yb.T @ Yb)
    return SDPResult(
        X=X_blocks, obj=obj, Y=Y_final,
        y=np.asarray(jax.device_get(y)),
        S=S_host,
        z=np.asarray(jax.device_get(z_dev)) if z_dev is not None else None,
        gap=gap, pinf=pinf, dinf=dinf, eta=eta, gradnorm=gradnorm,
        time=elapsed, status=status, iterations=it, fac_size=fac_size,
        rtr_iters=total_tr, hess_calls=total_hess, history=history,
        timers=timers.t, sigma=sigma, tier=tier)
