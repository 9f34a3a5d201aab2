"""Dual multiblock Riemannian ADMM (JAX equivalent of
src/dual/ManiDSDP_multiblock.m): first ``nob`` slack blocks are
unit-diagonal (oblique), the rest Euclidean.

Same flat-factor design as the primal multiblock (one (p_max, N)
factor over concatenated block columns, masked product geometry), with
the dual family's dense objects restricted to the block diagonal via a
0/1 (N, N) mask: S = (Y'Y) .* BD is exactly the block-diagonal slack
the reference holds as a cell array, and every dense operand
(multiplier, bA, C, adjoints) is block-diagonal by construction, so
dense matmuls Y @ M stay correct.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SolverOptions, merged_options
from ..core import Problem, TROptions, make_trustregions
from ..manifolds.product import MaskedProduct
from ..ops.dualops import DualOp, SparseMat
from .common import (JitCache, PhaseTimers, SDPResult, SlowProgress,
                     bucketed, log_iter, make_line_search,
                     pad_rows)
from .dual_general import build_iab


def _make_problem(M: MaskedProduct, BD, pure: bool,
                  iAB: Optional[SparseMat]):

    def cost(Y, params):
        op, Xm, w, sigma = (params["op"], params["Xm"], params["w"],
                            params["sigma"])
        S = (Y.T @ Y) * BD.astype(Y.dtype)
        y = op.y_step(S)
        As = op.adjoint(y) - (S - op.C) - Xm / sigma
        Af = op.B.rmatvec(y) - op.cf - w / sigma
        f = jnp.dot(op.b, y) + 0.5 * sigma * \
            (jnp.sum(As * As) + jnp.dot(Af, Af))
        return f, (S, y, As, Af)

    def grad(Y, params, aux):
        op, sigma = params["op"], params["sigma"]
        _, _, As, Af = aux
        if pure:
            tt = op.bA - sigma * As
        else:
            tt = op.bA + sigma * (
                _iab_mat(iAB, op.n, Af)
                + op.adjoint(op.idAAt * op.apply(As)) - As)
        eG = 2.0 * Y @ tt
        YeG = jnp.sum(Y * eG, axis=0) * M.mask.astype(Y.dtype)
        return eG - Y * YeG[None, :], (tt, YeG)

    def hess(Y, U, params, aux, gaux):
        op, sigma = params["op"], params["sigma"]
        tt, YeG = gaux
        T = (U.T @ Y) * BD.astype(Y.dtype)   # blockwise U_i' Y_i
        yAU = op.adjoint(op.idAAt * op.apply(T))
        if pure:
            tYU = -2.0 * yAU
        else:
            tYU = -4.0 * yAU \
                + 2.0 * _iab_mat(iAB, op.n, _iab_rmat(iAB, T)) \
                + 2.0 * op.adjoint(op.idAAt * op.apply(yAU))
        eH = 2.0 * U @ tt + 2.0 * sigma * (Y @ (T + T.T)) \
            + 2.0 * sigma * (Y @ tYU)
        return eH - Y * (jnp.sum(Y * eH, axis=0)
                         * M.mask.astype(Y.dtype))[None, :] \
            - U * YeG[None, :]

    def cost_only(Y, params):
        return cost(Y, params)[0]

    return Problem(manifold=M, cost=cost, grad=grad, hess=hess), cost_only


def _iab_mat(iAB: SparseMat, n: int, u):
    flat = jnp.zeros(n * n, dtype=u.dtype)
    # iAB may be a closure in a lower-precision tCG trace: match dtypes
    flat = flat.at[iAB.row_c].add(
        iAB.val_c.astype(u.dtype) * jnp.take(u, iAB.col_c))
    return flat.reshape(n, n)


def _iab_rmat(iAB: SparseMat, Mat):
    vals = jnp.take(Mat.reshape(-1), iAB.row_c)
    return jax.ops.segment_sum(iAB.val_c.astype(vals.dtype) * vals,
                               iAB.col_c, num_segments=iAB.ncols,
                               indices_are_sorted=True)


def solve_dual_multiblock(A, b, c, ns: Sequence[int], nob: int,
                          f: int = 0, dAAt=None,
                          options: Optional[SolverOptions] = None,
                          **overrides) -> SDPResult:
    """SeDuMi dual multiblock input: A (m, f + sum n_i^2), free block
    first; K.s = ns, K.nob = nob."""
    opt = merged_options("dual_multiblock", options, **overrides)
    ns = [int(x) for x in ns]
    nb = len(ns)
    pure = (nob == nb)
    op = DualOp.build(A, b, c, 0, f=f, dAAt=dAAt, ns=ns)
    N, m = op.n, op.m
    off = np.concatenate([[0], np.cumsum(ns)]).astype(int)

    mask_np = np.zeros(N)
    BD_np = np.zeros((N, N))
    for bidx in range(nb):
        sl = slice(off[bidx], off[bidx + 1])
        BD_np[sl, sl] = 1.0
        if bidx < nob:
            mask_np[sl] = 1.0
    M = MaskedProduct(mask_np)
    BD = jnp.asarray(BD_np)

    iAB = None
    if not pure and f > 0:
        # remap iAB rows into the flat column space
        import scipy.sparse as sp
        Acsr = sp.csr_matrix(A)
        Bm = Acsr[:, :f]
        Ap = Acsr[:, f:].tocoo()
        if dAAt is None:
            dAAt_l = np.zeros(m)
            np.add.at(dAAt_l, Ap.row, Ap.data ** 2)
        else:
            dAAt_l = np.asarray(dAAt, dtype=np.float64).ravel()
        D_inv = sp.diags(1.0 / dAAt_l)
        Mi = (Ap.T @ (D_inv @ Bm)).tocoo()
        nsa = np.asarray(ns, dtype=np.int64)
        off2 = np.concatenate([[0], np.cumsum(nsa ** 2)])
        bl = np.searchsorted(off2, Mi.row, side="right") - 1
        loc = Mi.row - off2[bl]
        gi = loc % nsa[bl] + off[bl]
        gj = loc // nsa[bl] + off[bl]
        lin_rm = gi * N + gj
        iAB = SparseMat.from_scipy(
            sp.coo_matrix((Mi.data, (lin_rm, Mi.col)), shape=(N * N, f)))

    if opt.verbose:
        print("ManiSDP-JAX (dual multiblock) is starting...", flush=True)
        print(f"SDP size: n = {max(ns)}, m = {m}", flush=True)

    problem, cost_only = _make_problem(M, BD, pure, iAB)
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
    op32 = problem32 = None
    if opt.inner_dtype == "mixed":
        cast32 = lambda x: x.astype(jnp.float32) \
            if jnp.issubdtype(x.dtype, jnp.floating) else x
        op32 = jax.tree_util.tree_map(cast32, op)
        iab32 = None if iAB is None else \
            jax.tree_util.tree_map(cast32, iAB)
        problem32, _ = _make_problem(M, BD, pure, iab32)

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
            solve32 = jax.jit(make_trustregions(problem32, tr32))
        return solve, solve32, ls

    cache = JitCache(factory)

    normc = float(1.0 + np.sqrt(
        float(jnp.sum(op.C * op.C)) + float(jnp.dot(op.cf, op.cf))))

    @jax.jit
    def stats(Y, Xm, w, sigma):
        S = (Y.T @ Y) * BD
        y = op.y_step(S)
        As = op.adjoint(y) - (S - op.C)
        Af = op.B.rmatvec(y) - op.cf
        pinf = (jnp.sqrt(jnp.sum(As * As)) + jnp.linalg.norm(Af)) / normc
        by = jnp.dot(op.b, y)
        if pure:
            Xm_new = Xm - sigma * As
        else:
            Xm_new = Xm + sigma * (
                _iab_mat(iAB, N, Af - w / sigma)
                + op.adjoint(op.idAAt * op.apply(As - Xm / sigma)) - As)
        w_new = w - sigma * Af
        eX = Xm_new + op.bA
        z = jnp.sum(S * eX, axis=0) * M.mask
        Xp = eX - jnp.diag(z)
        obj = jnp.sum(op.C * eX) + jnp.dot(op.cf, w_new) + jnp.sum(z)
        gap = jnp.abs(obj - by) / (1.0 + jnp.abs(obj) + jnp.abs(by))
        return S, y, Xm_new, w_new, Xp, z, obj, pinf, gap

    def block_certs(Xp_dev):
        Xp_h = np.asarray(jax.device_get(Xp_dev))
        out = []
        for bidx in range(nb):
            sl = slice(off[bidx], off[bidx + 1])
            vals, vecs = np.linalg.eigh(Xp_h[sl, sl])
            out.append((vals, vecs))
        dinf = max(max(0.0, -v[0]) / (1.0 + abs(v[-1])) for v, _ in out)
        return out, dinf

    p0 = opt.p0 if np.ndim(opt.p0) else [int(opt.p0)] * nb
    ps = [ns[i] if ns[i] < opt.min_facsize else int(p0[i])
          for i in range(nb)]
    p_pad = bucketed(max(ps), opt.p_bucket)

    key = jax.random.PRNGKey(opt.seed)
    key, sub = jax.random.split(key)
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

    Xm = jnp.zeros((N, N))
    w = jnp.zeros(op.f)
    sigma = opt.sigma0
    slow = SlowProgress(50, 100)
    status = 0
    total_tr = total_hess = 0
    fac_size, history = [], []
    t0 = time.time()
    obj = gap = pinf = dinf = gradnorm = eta = np.nan
    S_dev = y_dev = Xp_dev = z_dev = None
    it = 0
    tier = 0
    use32 = opt.inner_dtype == "tcg32"
    frozen = 0          # consecutive endgame iterations with frozen sigma

    timers = PhaseTimers()
    for it in range(1, opt.max_outer + 1):
        fac_size.append(max(ps))
        solve, solve32, line_search = cache((p_pad, tier, use32))
        params = dict(op=op, Xm=Xm, w=w, sigma=jnp.float64(sigma))
        with timers.timed("rtr"):
            if U_dir is not None:
                Y = line_search(Y, jnp.asarray(U_dir), params)
            typdist = MaskedProduct.typicaldist(ns, ps, nob)
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
        gradnorm = float(res.norm_grad)
        total_tr += int(res.iters)
        total_hess += int(res.inner_iters)

        with timers.timed("stats"):
            (S_dev, y_dev, Xm, w, Xp_dev, z_dev, obj_d, pinf_d,
             gap_d) = stats(Y, Xm, w, jnp.float64(sigma))
            obj, pinf, gap = float(obj_d), float(pinf_d), float(gap_d)
        with timers.timed("cert"):
            certs, dinf = block_certs(Xp_dev)

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

        # per-block rank update (ManiDSDP_multiblock.m:145-182)
        Y_host = np.array(jax.device_get(Y))
        U_host = np.zeros_like(Y_host) if opt.line_search else None
        for bidx in range(nb):
            if ns[bidx] < opt.min_facsize:
                continue
            sl = slice(off[bidx], off[bidx + 1])
            pb = ps[bidx]
            Yb = Y_host[:, sl]
            G = Yb @ Yb.T
            wv, V = np.linalg.eigh(G)
            wv = np.maximum(wv, 0.0)
            ordr = np.argsort(wv)[::-1][:max(pb, 1)]
            e_sv = np.sqrt(wv[ordr])
            r = int(np.sum(e_sv > opt.theta * e_sv[0]))   # strict >
            r = max(r, 1)
            if r < pb:
                Ynew = V[:, ordr[:r]].T @ Yb
                Y_host[:, sl] = 0.0
                Y_host[:r, sl] = Ynew
                ps[bidx] = r
                pb = r
            vals, vecs = certs[bidx]
            if bidx < nob:
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

    Y_final = np.asarray(jax.device_get(Y))
    Xp_h = np.asarray(jax.device_get(Xp_dev)) if Xp_dev is not None else None
    X_blocks = [Xp_h[off[i]:off[i + 1], off[i]:off[i + 1]]
                for i in range(nb)] if Xp_h is not None else None
    return SDPResult(
        X=X_blocks, obj=obj, Y=Y_final,
        y=np.asarray(jax.device_get(y_dev)) if y_dev is not None else None,
        S=np.asarray(jax.device_get(S_dev)) if S_dev is not None else None,
        z=np.asarray(jax.device_get(z_dev)) if z_dev is not None else None,
        gap=gap, pinf=pinf, dinf=dinf, eta=eta, gradnorm=gradnorm,
        time=elapsed, status=status, iterations=it, fac_size=fac_size,
        rtr_iters=total_tr, hess_calls=total_hess, history=history,
        timers=timers.t, sigma=sigma, tier=tier)
