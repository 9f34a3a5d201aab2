"""Batched-instance MaxCut driver: B independent unit-diagonal SDPs
solved concurrently on one device or data-parallel over a ``batch`` mesh
axis.

The reference is strictly one-instance-at-a-time (single-process MATLAB,
SURVEY §2.7); instance batching is new capability: the RTR
inner solve, saddle-escape line search and dual-certificate eigensolves
are vmapped over the instance axis, so one kernel launch serves the
whole fleet, and a ``jax.sharding`` batch axis spreads instances
across devices with zero cross-instance communication.

Capabilities:
  - RAGGED n: instances of different sizes are grouped into n-buckets
    (n rounded up to a multiple of ``n_bucket``) and each bucket is
    batch-solved; within a bucket smaller instances are zero-padded —
    padded columns are free unit vectors with zero cost coupling, so
    cost/grad/certificates are exactly those of the unpadded problem
    (the padded block of S is -diag(z_pad) = 0, adding only zero
    eigenvalues).
  - SPARSE C: scipy-sparse inputs batch as SymCOO pytrees padded to a
    common nnz (padding entries carry value 0), vmapped through the
    same gather/segment kernels as the single-instance sparse path.

Per-instance adaptive rank is kept: each instance has its own active
rank p_b inside one shared padded buffer (p_pad, n); padding rows are
exact zeros, which every manifold op and the RTR preserve.

Semantics per instance match solve_maxcut_unitdiag
(src/primal/ManiSDP_onlyunitdiag.m): RTR -> dual certificate
S = C - diag(z) -> rank truncate via factor SVD -> escape along negative
eigenvectors of S.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

from ..config import SolverOptions, merged_options
from ..core import TROptions, make_trustregions
from ..manifolds import Oblique
from ..ops.sparse import SymCOO
from .common import SDPResult, bucketed, make_line_search
from .maxcut import make_maxcut_problem


def _pad_sym_coo(C_sp, n_pad: int, nnz_pad: int):
    """Symmetrized COO arrays of one instance, zero-padded to
    (nnz_pad,) with entries at (0, 0) carrying value 0."""
    coo = sp.coo_matrix(C_sp)
    coo = sp.coo_matrix(0.5 * (coo + coo.T))
    order = np.lexsort((coo.row, coo.col))
    i = np.zeros(nnz_pad, dtype=np.int32)
    j = np.zeros(nnz_pad, dtype=np.int32)
    v = np.zeros(nnz_pad)
    k = coo.nnz
    i[:k] = coo.row[order]
    j[:k] = coo.col[order]
    v[:k] = coo.data[order]
    return i, j, v


def _batched_fns(opt: SolverOptions, dense: bool):
    """vmapped RTR solve + line search + z/obj over the instance axis."""
    if opt.inner_dtype == "mixed":
        import warnings
        warnings.warn(
            "solve_maxcut_batch does not implement the mixed-precision "
            "inner solve yet; running the batch in float64 "
            "(inner_dtype='mixed' ignored)", stacklevel=3)
    problem = make_maxcut_problem(dense)
    tr_opts = TROptions(maxiter=opt.tr_maxiter, maxinner=opt.tr_maxinner,
                        tolgradnorm=opt.tolgradnorm)
    solve = make_trustregions(problem, tr_opts)
    vsolve = jax.jit(jax.vmap(solve, in_axes=(0, 0, None)))

    def cost_only(Y, C):
        return problem.cost(Y, C)[0]

    line_search = make_line_search(cost_only, Oblique.renormalize,
                                   wrap=lambda f: f)
    vline = jax.jit(jax.vmap(line_search, in_axes=(0, 0, 0)))

    @jax.jit
    def vz(Y, C):
        if dense:
            z = jnp.einsum("bpn,bpn->bn", Y,
                           jnp.einsum("bpn,bnm->bpm", Y, C))
        else:
            z = jax.vmap(lambda Yb, Cb: Cb.quad_cols(Yb))(Y, C)
        return z, jnp.sum(z, axis=1)

    return vsolve, vline, vz


def solve_maxcut_batch(Cs, options: Optional[SolverOptions] = None,
                       mesh=None, n_bucket: int = 256,
                       **overrides) -> list:
    """Solve B unit-diagonal SDPs min <C_b, X> s.t. diag(X)=1, X>=0.

    ``Cs``: sequence of B symmetric cost matrices — dense arrays and/or
    scipy sparse, of ARBITRARY (mixed) sizes.  Instances are grouped
    into n-buckets (n rounded up to ``n_bucket``) and each bucket is
    batch-solved; dense vs sparse kernels follow the single-instance
    heuristic on the bucket's padded n.
    ``mesh``: optional jax.sharding.Mesh with a ``batch`` axis;
    instances of a bucket are sharded across it when the bucket size is
    a multiple of the axis size.

    Returns a list of B SDPResult, index-aligned with ``Cs``.
    """
    opt = merged_options("maxcut_unitdiag", options, **overrides)
    B = len(Cs)
    ns = [int(C.shape[0]) for C in Cs]
    buckets: dict = {}
    for b, n in enumerate(ns):
        nb = bucketed(n, n_bucket)
        buckets.setdefault(nb, []).append(b)

    if opt.verbose:
        print("ManiSDP-JAX (maxcut batch) is starting...", flush=True)
        print(f"batch = {B}, sizes = {sorted(set(ns))}, "
              f"buckets = {sorted(buckets)}", flush=True)

    out: list = [None] * B
    for nb in sorted(buckets):
        idxs = buckets[nb]
        group = [Cs[i] for i in idxs]
        results = _solve_group(group, [ns[i] for i in idxs], nb, opt,
                               mesh)
        for i, r in zip(idxs, results):
            out[i] = r
    return out


def _solve_group(Cs, ns, n: int, opt: SolverOptions, mesh) -> list:
    B = len(Cs)
    k_cert = opt.delta + 1

    # decide dense vs sparse on the padded bucket size (same heuristic
    # as the single-instance driver)
    nnzs = [sp.coo_matrix(C).nnz if sp.issparse(C)
            else int(np.count_nonzero(C)) for C in Cs]
    dense = (n <= opt.dense_cost_max_n or
             n * n <= opt.dense_cost_nnz_factor * max(max(nnzs), 1))

    # dense (B, n, n) cost (zero-padded) — also the host certificate's S
    Cs_dense = np.zeros((B, n, n))
    for b, C in enumerate(Cs):
        Cb = C.toarray() if sp.issparse(C) else np.asarray(C, float)
        Cb = 0.5 * (Cb + Cb.T)
        Cs_dense[b, :ns[b], :ns[b]] = Cb

    if dense:
        C_param = jnp.asarray(Cs_dense)
        batch_axes = 0
    else:
        nnz_pad = max(sp.coo_matrix(C).nnz for C in Cs)
        ii = np.zeros((B, nnz_pad), dtype=np.int32)
        jj = np.zeros((B, nnz_pad), dtype=np.int32)
        vv = np.zeros((B, nnz_pad))
        for b, C in enumerate(Cs):
            ii[b], jj[b], vv[b] = _pad_sym_coo(C, n, nnz_pad)
        C_param = SymCOO(i=jnp.asarray(ii), j=jnp.asarray(jj),
                         v=jnp.asarray(vv), n=n)
        batch_axes = 0

    sharding = None
    if mesh is not None and B % mesh.shape.get("batch", B + 1) == 0:
        from jax.sharding import NamedSharding, PartitionSpec as P
        sharding = NamedSharding(mesh, P("batch"))
        put = lambda x: jax.device_put(x, sharding)
        C_param = jax.tree_util.tree_map(
            lambda x: jax.device_put(x, sharding)
            if hasattr(x, "ndim") and x.ndim >= 1 else x, C_param)
    else:
        put = lambda x: x

    fns_cache: dict = {}

    def fns(p_pad):
        if p_pad not in fns_cache:
            fns_cache[p_pad] = _batched_fns(opt, dense)
        return fns_cache[p_pad]

    key = jax.random.PRNGKey(opt.seed)
    p = np.full(B, opt.p0, dtype=np.int64)
    p_pad = bucketed(int(p.max()), opt.p_bucket)
    typdist = float(np.pi * np.sqrt(n))

    keys = jax.random.split(key, B)
    Y = np.zeros((B, p_pad, n))
    for b in range(B):
        Y[b, :opt.p0] = np.asarray(
            Oblique.rand(keys[b], opt.p0, n, opt.p0))
    Y = put(jnp.asarray(Y))
    U_dir = None

    done = np.zeros(B, dtype=bool)
    status = np.zeros(B, dtype=np.int64)
    obj = np.full(B, np.nan)
    dinf = np.full(B, np.nan)
    it_done = np.zeros(B, dtype=np.int64)
    z_final = np.zeros((B, n))
    t0 = time.time()
    it = 0

    for it in range(1, opt.max_outer + 1):
        vsolve, vline, vz = fns(p_pad)
        if U_dir is not None:
            Y = vline(Y, put(jnp.asarray(U_dir)), C_param)
        res = vsolve(Y, C_param, typdist)
        Y = res.Y

        z_dev, obj_dev = vz(Y, C_param)
        z_h = np.asarray(jax.device_get(z_dev))
        obj_now = np.asarray(jax.device_get(obj_dev))

        # batched dual certificate on host: S_b = C_b - diag(z_b);
        # padded columns contribute exactly zero eigenvalues
        S = Cs_dense.copy()
        S[:, np.arange(n), np.arange(n)] -= z_h
        vals, vecs = np.linalg.eigh(S)
        lam_min, lam_max = vals[:, 0], vals[:, -1]
        dinf_now = np.maximum(0.0, -lam_min) / (1.0 + lam_max)
        num_neg = np.sum(vals < 0, axis=1)

        newly = (~done) & (dinf_now < opt.tol)
        for b in np.nonzero(~done)[0]:
            obj[b], dinf[b] = obj_now[b], dinf_now[b]
            z_final[b] = z_h[b]
            it_done[b] = it
        done |= newly
        if opt.verbose:
            print(f"Iter {it}, done {int(done.sum())}/{B}, "
                  f"median dinf:{np.median(dinf_now):0.1e}, "
                  f"p_pad:{p_pad}, time:{time.time() - t0:0.2f}s",
                  flush=True)
        if done.all():
            break

        # ---- per-instance rank update (host) ----
        Y_h = np.asarray(jax.device_get(Y))
        p_next = p.copy()
        plans = []
        for b in range(B):
            if done[b]:
                plans.append(None)
                continue
            Yb = Y_h[b, :p[b]]
            sv = np.linalg.svd(Yb, compute_uv=False) if p[b] > 1 else \
                np.array([np.linalg.norm(Yb)])
            r = max(int(np.sum(sv >= opt.theta * sv[0])), 1)
            nne = max(min(int(num_neg[b]), opt.delta), 1)
            plans.append((r, nne))
            p_next[b] = (r if r <= p[b] - 1 else p[b]) + nne
        p_pad_next = bucketed(int(p_next.max()), opt.p_bucket)
        p_pad_next = max(p_pad_next, p_pad)

        Y_new = np.zeros((B, p_pad_next, n))
        U_new = np.zeros((B, p_pad_next, n))
        for b in range(B):
            if done[b]:
                Y_new[b, :p[b]] = Y_h[b, :p[b]]
                continue
            r, nne = plans[b]
            Yb = Y_h[b, :p[b]]
            if r <= p[b] - 1:
                Uf, sf, Vtf = np.linalg.svd(Yb, full_matrices=False)
                Yb = Uf[:, :r].T @ Yb
            pb = Yb.shape[0]
            vs = vecs[b][:, :nne]
            if opt.line_search:
                Y_new[b, :pb] = Yb
                U_new[b, pb:pb + nne] = vs.T
            else:
                Yb = np.vstack([Yb, opt.alpha * vs.T])
                Yb = Yb / np.sqrt(np.sum(Yb ** 2, axis=0))
                Y_new[b, :pb + nne] = Yb
        p = p_next
        p_pad = p_pad_next
        Y = put(jnp.asarray(Y_new))
        U_dir = U_new if opt.line_search else None

    for b in np.nonzero(~done)[0]:
        status[b] = 1

    elapsed = time.time() - t0
    if opt.verbose:
        print(f"ManiSDP-JAX batch: {int(done.sum())}/{B} optimal, "
              f"time = {elapsed:0.2f}s", flush=True)

    Y_h = np.asarray(jax.device_get(Y))
    out = []
    for b in range(B):
        nb = ns[b]
        Yb = Y_h[b, :p[b], :nb]            # strip n padding
        out.append(SDPResult(
            X=Yb.T @ Yb, obj=float(obj[b]), Y=Yb, z=z_final[b, :nb],
            dinf=float(dinf[b]), eta=float(dinf[b]),
            time=elapsed, status=int(status[b]),
            iterations=int(it_done[b]) if done[b] else it))
    return out
