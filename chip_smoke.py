#!/usr/bin/env python
"""Bring-up check of the solver on one NVIDIA GPU.

    python chip_smoke.py          # one GPU: every phase below
    python chip_smoke.py --four   # four GPUs: the mesh-sharded paths only

Drives the three solver engines (MaxCut RTR, the primal AL, the dual
ADMM with the q^4 SOS operator) once through the public entry points,
at the sizes the reference publishes, on instances made from a seed.
Every solve must reach status 0 with eta <= 1e-8 and pass an
independent host check (numpy / scipy on the returned factor and
multipliers).  The ``ops`` phase compares the device operators with
plain host references at real widths.

Each phase prints one JSON line: the card's name and power limit,
set-up (instance + compile) and warm wall / solver-internal seconds,
status, eta, outer / RTR / Hv counts, precision fallbacks, the
process's peak device memory so far, and its check.  The last line is
``{"ok": true, "device": {...}}``; the script exits non-zero without it
when JAX finds no GPU or any check fails.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import scipy.sparse as sp

TOL = 1e-8          # solver KKT target
CHECK_TOL = 1e-7    # independent host re-check of dinf / pinf


# -- device and card ---------------------------------------------------------

def require_gpu():
    """The first JAX device, or exit: this script measures a GPU and
    never falls back to the CPU."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.stderr.write(f"chip_smoke: no GPU (JAX platform "
                         f"{dev.platform!r}); refusing to run\n")
        sys.exit(2)
    return dev


def card_lines():
    """``name, power.limit`` of every card, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return [ln.strip() for ln in out.splitlines() if ln.strip()]


def card():
    name, limit = card_lines()[0].rsplit(",", 1)
    return {"name": name.strip(), "power_limit": limit.strip()}


def peak_bytes():
    import jax
    stats = jax.devices()[0].memory_stats() or {}
    return int(stats.get("peak_bytes_in_use", 0))


def rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


# -- seeded instances -------------------------------------------------

def g1_class(seed=1):
    from manisdp.frontends.gset import maxcut_cost_from_weights, random_graph
    return maxcut_cost_from_weights(random_graph(800, 0.06, seed))


def torus_class(rows=100, cols=100, seed=1):
    from manisdp.frontends.gset import (maxcut_cost_from_weights,
                                        toroidal_grid)
    return maxcut_cost_from_weights(toroidal_grid(rows, cols, seed))


# -- independent host KKT checks ---------------------------------------

def _extreme_eigs(S):
    """(lam_min, lam_max) of a symmetric matrix, dense or sparse."""
    if sp.issparse(S) and S.shape[0] > 4000:
        from scipy.sparse.linalg import eigsh
        # ARPACK stops on a residual relative to |theta|: shift the
        # (near-zero, clustered) bottom of the spectrum away from 0 by a
        # Gershgorin bound so the test means an absolute ~1e-12 * c
        c = 1.0 + float(abs(S).sum(axis=1).max())
        eye = sp.identity(S.shape[0], format="csr")
        lo = eigsh(S + c * eye, k=1, which="SA", tol=1e-12, ncv=64,
                   return_eigenvectors=False)[0] - c
        hi = eigsh(S, k=1, which="LA", tol=1e-12, ncv=64,
                   return_eigenvectors=False)[0]
        return float(lo), float(hi)
    S = S.toarray() if sp.issparse(S) else np.asarray(S)
    w = np.linalg.eigvalsh(0.5 * (S + S.T))
    return float(w[0]), float(w[-1])


def maxcut_kkt(C, Y):
    """KKT residuals of min <C,X> s.t. diag(X) = 1 at X = Y'Y.

    z = diag(C X) is the optimal multiplier of the unit diagonal, so
    S = C - Diag(z) must be psd: dinf = max(0, -lam_min) / (1 + lam_max)
    (ManiSDP_onlyunitdiag.m:45-51)."""
    Y = np.asarray(Y, dtype=np.float64)
    CY = (C @ Y.T).T if sp.issparse(C) else Y @ np.asarray(C)
    z = np.sum(Y * CY, axis=0)
    S = C - sp.diags(z) if sp.issparse(C) else np.asarray(C) - np.diag(z)
    lo, hi = _extreme_eigs(S)
    return {"diag_err": float(np.max(np.abs(np.sum(Y * Y, axis=0) - 1.0))),
            "obj": float(np.sum(z)), "lam_min": lo, "lam_max": hi,
            "dinf": max(0.0, -lo) / (1.0 + hi)}


def sdp_kkt(At, b, c, n, Y, y):
    """KKT residuals of min <c, vec X> s.t. At' vec X = b, X psd at
    X = Y'Y with multipliers y (SeDuMi layout, column-major vec)."""
    Y = np.asarray(Y, dtype=np.float64)
    X = Y.T @ Y
    Ax = At.T @ X.ravel(order="F")
    S = (np.asarray(c) - At @ np.asarray(y)).reshape(n, n, order="F")
    lo, hi = _extreme_eigs(S)
    obj = float(np.asarray(c) @ X.ravel(order="F"))
    by = float(np.asarray(b) @ np.asarray(y))
    return {"pinf": float(np.linalg.norm(Ax - b) /
                          (1.0 + np.linalg.norm(b))),
            "dinf": max(0.0, -lo) / (1.0 + hi),
            "gap": abs(obj - by) / (1.0 + abs(obj) + abs(by)),
            "obj": obj, "lam_min": lo, "lam_max": hi}


# -- phase plumbing -------------------------------------------------------

def cold_warm(solve):
    """Run a solve twice: the first run (compiles) is set-up, the
    second is the measured warm run."""
    t0 = time.perf_counter()
    solve()
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = solve()
    return res, cold, time.perf_counter() - t0


def solver_fields(res, cold, warm):
    return {"setup_s": cold, "wall_s": warm, "solve_s": float(res.time),
            "status": int(res.status), "eta": float(res.eta),
            "obj": float(res.obj), "outer": int(res.iterations),
            "rtr": int(res.rtr_iters), "hv": int(res.hess_calls),
            "precision_fallbacks": int(res.precision_fallbacks),
            "timers": res.timers}


def converged(res):
    return res.status == 0 and res.eta <= TOL


def emit(phase, fields, check, ok):
    line = {"phase": phase, "card": card(), **fields,
            "peak_bytes_in_use": peak_bytes(), "check": check,
            "ok": bool(ok)}
    print(json.dumps(line), flush=True)
    return bool(ok)


# -- ops: device operators against plain references -----------------------

def _bits(q):
    return np.uint64(1) << np.arange(q, dtype=np.uint64)


def _expanded_to_orig(q):
    """Original-basis column of every expanded column.  Expanded basis:
    [1, 1', x_a (a < q), q x q grid: (i, j) = x_i x_j for i != j and
    (a, a) = x_a'], each original column [1, x_a, x_ab] exactly twice;
    original order as frontends.sos.bqpsos (squarefree prefix of the
    degree-4 monomial basis)."""
    from manisdp.frontends.monomials import monomial_basis
    bits = _bits(q)
    grid = bits[:, None] ^ bits[None, :]
    grid[np.arange(q), np.arange(q)] = bits
    emask = np.concatenate([np.zeros(2, np.uint64), bits, grid.ravel()])
    mb = 1 + q + q * (q - 1) // 2
    omask = (monomial_basis(q, 2, max_power=1).astype(np.uint64).T
             * bits).sum(axis=1)
    assert omask.shape[0] == mb
    order = np.argsort(omask)
    return order[np.searchsorted(omask[order], emask)]


def _sos_flat_rows(q):
    """bqpsos row of every slot of SymDualOp's flat per-degree layout
    [y0, y1, Y2, Y3, Y4] (-1 on repeated-index slots)."""
    from manisdp.frontends.monomials import monomial_basis
    bits = _bits(q)
    masks4 = (monomial_basis(q, 4, max_power=1).astype(np.uint64).T
              * bits).sum(axis=1)
    order = np.argsort(masks4, kind="stable")
    i = np.arange(q)
    parts, keep = [np.zeros(1, np.uint64), bits], [np.ones(1 + q, bool)]
    m2 = bits[:, None] ^ bits[None, :]
    k2 = i[:, None] != i[None, :]
    m3 = m2[:, :, None] ^ bits[None, None, :]
    k3 = k2[:, :, None] & k2[:, None, :] & k2[None, :, :]
    m4 = m3[:, :, :, None] ^ bits[None, None, None, :]
    k4 = (k3[:, :, :, None] & k2[:, None, None, :]
          & k2[None, :, None, :] & k2[None, None, :, :])
    for m, k in ((m2, k2), (m3, k3), (m4, k4)):
        parts.append(m.ravel())
        keep.append(k.ravel())
    mask, keep = np.concatenate(parts), np.concatenate(keep)
    rows = order[np.searchsorted(masks4[order], mask)]
    return np.where(keep, rows, -1)


def _mom_slot_map(q):
    """frontends.moments.bqpmom row -> SymMomOp flat residual slot."""
    from manisdp.frontends.monomials import monomial_basis
    q2, q3 = q * q, q ** 3
    bD1, bD2 = 1, 1 + q
    bSv = bD2 + q2
    bSp = bSv + q2
    bE2 = bSp + q3
    bE4 = bE2 + q2
    bE6 = bE4 + q3
    iu, ju = np.triu_indices(q, k=1)
    order = np.lexsort((iu, ju))
    pu, pv = iu[order], ju[order]
    idx = [np.zeros(1, np.int64), bD1 + np.arange(q),
           np.stack([bD2 + pu * q + pv, bD2 + pv * q + pu], 1).ravel()]
    for k in range(q):
        b = np.arange(q)
        idx.append(bSv + k * q + b[b != k])
        sel = (pu != k) & (pv != k)
        idx.append(bSp + k * q2 + pu[sel] * q + pv[sel])
    # substitution-class rows follow the degree-4 label order; only
    # classes of squarefree support (>= 2 entry pairs) emit rows
    spm = monomial_basis(q, 4, max_power=2, drop_all_even=True)
    sq = ~np.any(spm == 2, axis=0)
    deg = np.sum(spm, axis=0)
    cols = np.nonzero(sq & (deg >= 2))[0]
    sup = [np.nonzero(spm[:, t])[0] for t in cols]
    for s in sup:
        if len(s) == 2:
            idx.append(np.array([bE2 + s[0] * q + s[1]]))
        elif len(s) == 3:
            a, b, c = s
            idx.append(np.array([bE4 + a * q2 + b * q + c,
                                 bE4 + b * q2 + a * q + c]))
        else:
            a, b, c, d = s
            idx.append(np.array([bE6 + ((a * q + b) * q + c) * q + d,
                                 bE6 + ((b * q + a) * q + c) * q + d]))
    return np.concatenate(idx)


def _time(fn, reps=5):
    """Warm seconds per call (block_until_ready inside the window)."""
    import jax
    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(reps):
        jax.block_until_ready(fn())
    return (time.perf_counter() - t0) / reps


def check_symdual(q=60, seed=1):
    import jax
    import jax.numpy as jnp
    from manisdp.frontends.sos import bqpsos
    from manisdp.frontends.workloads import bqp_instance
    from manisdp.ops.sparse import ConstraintOp
    from manisdp.ops.symdual import SymDualOp
    Q, e = bqp_instance(q, seed)
    A, _, _, mb = bqpsos(Q, e, q)
    op = SymDualOp.build_bqpsos(Q, e, q)
    cols = _expanded_to_orig(q)
    rows = _sos_flat_rows(q)
    keep = rows >= 0
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((mb, mb))
    M = M + M.T
    # apply: every expanded class holds 4x the original entries
    y_ref = 4.0 * (A @ M.ravel(order="F"))
    Mx = jnp.asarray(M[np.ix_(cols, cols)])
    y_dev = np.asarray(op.apply_flat(Mx))
    apply_rel = rel(y_dev[keep], y_ref[rows[keep]])
    # adjoint: class values broadcast back to every (copy) entry;
    # repeated-index slots are poisoned and must never be read
    yc = rng.standard_normal(A.shape[0])
    yflat = np.where(keep, yc[np.maximum(rows, 0)], 1e9)
    W_ref = (A.T @ yc).reshape(mb, mb, order="F")[np.ix_(cols, cols)]
    W_dev = np.asarray(op.adjoint(jnp.asarray(yflat)))
    adjoint_rel = rel(W_dev, W_ref)
    # timing: the gather-free tensor route vs the gather/segment
    # ConstraintOp on the same bqpsos rows (original basis)
    t_sym = _time(lambda: op.adjoint(op.apply(Mx)))
    cop = ConstraintOp.build(A.T.tocsc(), np.zeros(A.shape[0]),
                             np.zeros(mb * mb), mb)
    Md = jnp.asarray(M)
    ev = Md[cop.pat.i, cop.pat.j]
    f = jax.jit(lambda e: cop.adjoint_on_pattern(cop.apply_from_e(e)))
    t_cop = _time(lambda: f(ev))
    return {"q": q, "apply_rel": apply_rel, "adjoint_rel": adjoint_rel,
            "apply_adjoint_s": {"SymDualOp": t_sym, "ConstraintOp": t_cop},
            "tol": 1e-10, "dtype": "float64"}, \
        apply_rel <= 1e-10 and adjoint_rel <= 1e-10


def check_symmom(q=60, seed=1):
    import jax.numpy as jnp
    from manisdp.frontends.moments import bqpmom
    from manisdp.frontends.workloads import bqp_instance
    from manisdp.ops.symmom import SymMomOp
    Q, e = bqp_instance(q, seed)
    data = bqpmom(q, Q, e)
    op = SymMomOp.build_bqpmom(Q, e, q)
    mb = data.K.s
    cols = _expanded_to_orig(q)
    smap = _mom_slot_map(q)
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((mb, mb))
    M = M + M.T
    y_ref = data.At.T @ M.ravel(order="F")
    y_dev = np.asarray(op.apply_from_e(jnp.asarray(M[np.ix_(cols, cols)])))
    apply_rel = rel(y_dev[smap], y_ref)
    # adjoint: the original coefficient matrix spreads /4 over the
    # 2 x 2 copy slots of every entry
    yr = rng.standard_normal(data.At.shape[1])
    yflat = np.zeros(op.m)
    yflat[smap] = yr
    W_ref = 0.25 * (data.At @ yr).reshape(mb, mb, order="F")
    W_dev = np.asarray(op.adjoint_on_pattern(jnp.asarray(yflat)))
    adjoint_rel = rel(W_dev, W_ref[np.ix_(cols, cols)])
    return {"q": q, "apply_rel": apply_rel, "adjoint_rel": adjoint_rel,
            "tol": 1e-10, "dtype": "float64"}, \
        apply_rel <= 1e-10 and adjoint_rel <= 1e-10


def check_devcert(C, seed=1):
    """DeviceCertSolver's certified lam_min bound of S = C - Diag(z)
    against scipy eigsh: the bound may never exceed the true lam_min
    by more than 1e-10 * scale."""
    import jax
    import jax.numpy as jnp
    from manisdp.ops.eigs_rr import DeviceCertSolver
    from manisdp.ops.sparse import SymCOO
    n = C.shape[0]
    z = np.random.default_rng(seed).uniform(-1.0, 1.0, n)
    S = (C - sp.diags(z)).tocsr()
    lam = _extreme_eigs(S)[0]
    ctx = {"C": SymCOO.from_scipy(sp.coo_matrix(C)), "z": jnp.asarray(z)}

    def mvr(V, ctx):
        return ctx["C"].matmat(V) - ctx["z"][None, :] * V

    solver = DeviceCertSolver(mvr, n, 9)
    t0 = time.perf_counter()
    res = solver.solve(ctx, jax.random.PRNGKey(seed), maxiter=400,
                       tol=1e-9)
    bound = float(res.lam_min)
    t_first = time.perf_counter() - t0
    t_warm = _time(lambda: solver.solve(ctx, jax.random.PRNGKey(seed),
                                        maxiter=400, tol=1e-9).lam_min, 2)
    scale = max(abs(float(res.lam_max)), abs(lam), 1.0)
    return {"n": n, "bound": bound, "eigsh_lam_min": float(lam),
            "slack_rel": (lam - bound) / scale, "first_call_s": t_first,
            "warm_s": t_warm, "tol": 1e-10, "dtype": "float64"}, \
        np.isfinite(bound) and bound <= lam + 1e-10 * scale


def check_eigh(seed=1):
    """Device f64 eigh against numpy at n = 1831, and both timed warm
    at the dense-certificate sizes."""
    import jax
    import jax.numpy as jnp
    rng = np.random.default_rng(seed)
    out, ok = {"tol": 1e-10, "dtype": "float64", "warm_s": {}}, True
    eigh = jax.jit(jnp.linalg.eigh)
    for n in (800, 1831, 2000, 3662):
        A = rng.standard_normal((n, n))
        A = A + A.T
        Ad = jnp.asarray(A)
        t_dev = _time(lambda: eigh(Ad), 3)
        t0 = time.perf_counter()
        w_np = np.linalg.eigh(A)[0]
        t_host = time.perf_counter() - t0
        out["warm_s"][str(n)] = {"device_f64": t_dev, "host_numpy": t_host}
        if n == 1831:
            out["rel_1831"] = rel(np.asarray(eigh(Ad)[0]), w_np)
            ok = out["rel_1831"] <= 1e-10
    return out, ok


def check_tcg32_hv(C_sparse, C_dense, seed=1):
    """The f32 Hessian-vector product of the MaxCut subproblem against
    the f64 one, under HIGHEST and DEFAULT matmul precision."""
    import jax
    import jax.numpy as jnp
    from manisdp.ops.sparse import SymCOO
    from manisdp.solvers.maxcut import make_maxcut_problem
    rng = np.random.default_rng(seed)
    out, ok = {}, True
    for name, C, dense in (("torus_sparse", C_sparse, False),
                           ("g1class_dense", C_dense, True)):
        n, p = C.shape[0], 40
        Y = rng.standard_normal((p, n))
        Y /= np.linalg.norm(Y, axis=0)
        U = rng.standard_normal((p, n))
        U -= Y * np.sum(Y * U, axis=0)
        Cp = jnp.asarray(C.toarray()) if dense else \
            SymCOO.from_scipy(sp.coo_matrix(C))
        prob = make_maxcut_problem(dense)

        def hv(Y, U, C):
            _, aux = prob.cost(Y, C)
            _, gaux = prob.grad(Y, C, aux)
            return prob.hess(Y, U, C, aux, gaux)

        h64 = np.asarray(jax.jit(hv)(jnp.asarray(Y), jnp.asarray(U), Cp))
        f32 = lambda t: jax.tree_util.tree_map(
            lambda x: x.astype(jnp.float32)
            if jnp.issubdtype(x.dtype, jnp.floating) else x, t)
        errs = {}
        for prec in ("highest", "default"):
            with jax.default_matmul_precision(prec):
                h32 = jax.jit(hv)(*f32((jnp.asarray(Y), jnp.asarray(U),
                                        Cp)))
            errs[prec] = float(np.linalg.norm(np.asarray(h32) - h64)
                               / np.linalg.norm(h64))
        out[name] = errs
        ok = ok and errs["highest"] <= 1e-4
    return out, ok


def phase_ops(C_torus, C_g1, q=60):
    checks = {}
    checks["symdual"], ok1 = check_symdual(q)
    checks["symmom"], ok2 = check_symmom(q)
    checks["devcert"], ok3 = check_devcert(C_torus)
    checks["eigh_f64"], ok4 = check_eigh()
    checks["tcg32_hv"], ok5 = check_tcg32_hv(C_torus, C_g1)
    return emit("ops", {}, checks, ok1 and ok2 and ok3 and ok4 and ok5)


# -- solver phases -------------------------------------------------------

def phase_maxcut_g1(C):
    import jax
    from manisdp import solve_maxcut_unitdiag
    solve = lambda: solve_maxcut_unitdiag(C, p0=40, verbose=False)
    res, cold, warm = cold_warm(solve)
    kkt = maxcut_kkt(C, res.Y)
    with jax.default_device(jax.devices("cpu")[0]):
        res_cpu = solve()
    agree = abs(res_cpu.obj - res.obj) / abs(res_cpu.obj)
    check = {**kkt, "cpu_obj": float(res_cpu.obj), "cpu_obj_rel": agree,
             "cpu_status": int(res_cpu.status)}
    ok = (converged(res) and kkt["diag_err"] <= 1e-10 and
          kkt["dinf"] <= CHECK_TOL and agree <= 1e-7)
    return emit("maxcut_g1class", solver_fields(res, cold, warm), check, ok)


def phase_maxcut_torus(C):
    from manisdp import solve_maxcut_unitdiag
    res, cold, warm = cold_warm(
        lambda: solve_maxcut_unitdiag(C, p0=40, verbose=False))
    kkt = maxcut_kkt(C, res.Y)
    ok = (converged(res) and kkt["diag_err"] <= 1e-10 and
          kkt["dinf"] <= CHECK_TOL)
    return emit("maxcut_torus100", solver_fields(res, cold, warm), kkt, ok)


def phase_mc(half=1000, samples=800000):
    from manisdp import solve_sdp
    from manisdp.frontends.workloads import matrix_completion
    from manisdp.recipes import recipe
    data, _ = matrix_completion(half, half, rank=10, m_samples=samples,
                                seed=3)
    _, kw = recipe("mc")
    kw = dict(kw, delta=10, tr_maxinner=6, tr_maxiter=8, theta=1e-2,
              inner_dtype="tcg32")
    n = data.K.s
    res, cold, warm = cold_warm(lambda: solve_sdp(
        data.At, data.b, data.c, n, verbose=False, **kw))
    kkt = sdp_kkt(data.At, data.b, data.c, n, res.Y, res.y)
    ok = converged(res) and kkt["pinf"] <= CHECK_TOL and \
        kkt["dinf"] <= CHECK_TOL
    return emit("mc_n2000", solver_fields(res, cold, warm), kkt, ok)


def phase_bqp_dual(q=60, seed=1):
    from manisdp.frontends.workloads import bqp_instance
    from manisdp.solvers.dual_unitdiag import solve_bqp_sos_dual
    from manisdp.solvers.primal_mom import solve_bqp_mom
    Q, e = bqp_instance(q, seed)
    res, cold, warm = cold_warm(lambda: solve_bqp_sos_dual(
        Q, e, q, line_search=True, inner_dtype="tcg32", p_bucket=192,
        verbose=False))
    t0 = time.perf_counter()
    prim = solve_bqp_mom(Q, e, q, inner_dtype="tcg32", p_bucket=192,
                         verbose=False)
    agree = abs(prim.obj - res.obj) / abs(prim.obj)
    check = {"q": q, "primal_obj": float(prim.obj),
             "primal_status": int(prim.status),
             "primal_eta": float(prim.eta), "primal_outer":
             int(prim.iterations), "primal_wall_s": time.perf_counter() - t0,
             "primal_solve_s": float(prim.time), "obj_rel": agree,
             "tol": 1e-6}
    ok = converged(res) and converged(prim) and agree <= 1e-6
    return emit("bqp60_dual", solver_fields(res, cold, warm), check, ok)


# -- four cards ------------------------------------------------------------

def _sharding_report(**arrays):
    """Each array's sharding and device count (no array may silently
    sit on device 0 only)."""
    return {k: {"sharding": str(a.sharding),
                "devices": len(a.sharding.device_set)}
            for k, a in arrays.items()}


def phase_four(C_torus, q_mom=30, q=60):
    import jax
    import jax.numpy as jnp
    from manisdp import solve_unitdiag
    from manisdp.core import TROptions, make_trustregions
    from manisdp.frontends.moments import bqpmom
    from manisdp.frontends.workloads import bqp_instance
    from manisdp.ops import symdual
    from manisdp.parallel.mesh import (_maxcut_problem, make_mesh,
                                       sharded_maxcut_solve)
    from manisdp.parallel.symdual_sharded import ShardedSymDualOp
    ndev = len(jax.devices())
    mesh = make_mesh(ndev, "model")
    ok_all = True

    # tensor-parallel RTR solve on the dense torus cost
    n, p = C_torus.shape[0], 40
    rng = np.random.default_rng(1)
    Y = rng.standard_normal((p, n))
    Y = jnp.asarray(Y / np.linalg.norm(Y, axis=0))
    C = jnp.asarray(C_torus.toarray())
    opts = TROptions(maxiter=3, maxinner=20, tolgradnorm=1e-8)
    typ = float(np.pi * np.sqrt(n))
    solve, shard = sharded_maxcut_solve(mesh, opts)
    Ys, Cs = shard(Y, C)
    t0 = time.perf_counter()
    res = jax.block_until_ready(solve(Ys, Cs, typ))
    t_sh = time.perf_counter() - t0
    ref = jax.jit(make_trustregions(_maxcut_problem(), opts))(Y, C, typ)
    fx_rel = abs(float(res.fx) - float(ref.fx)) / abs(float(ref.fx))
    y_rel = rel(res.Y, ref.Y)
    ok = fx_rel <= 1e-8 and y_rel <= 1e-6
    ok_all &= emit(f"four_sharded_maxcut_torus_n{n}", {"wall_s": t_sh}, {
        "fx": float(res.fx), "fx_one_card": float(ref.fx),
        "fx_rel": fx_rel, "Y_rel": y_rel, "tol": {"fx": 1e-8, "Y": 1e-6},
        "shardings": _sharding_report(Y=Ys, C=Cs, Y_out=res.Y)}, ok)

    # mesh-sharded primal AL on the bqpmom q=30 relaxation
    Q, e = bqp_instance(q_mom, 1)
    d = bqpmom(q_mom, Q, e)
    t0 = time.perf_counter()
    r4 = solve_unitdiag(d.At, d.b, d.c, d.K.s, mesh=mesh, verbose=False)
    t4 = time.perf_counter() - t0
    r1 = solve_unitdiag(d.At, d.b, d.c, d.K.s, verbose=False)
    obj_rel = abs(r4.obj - r1.obj) / abs(r1.obj)
    ok = converged(r4) and converged(r1) and obj_rel <= 1e-6
    ok_all &= emit(f"four_sharded_unitdiag_bqpmom{q_mom}",
                   solver_fields(r4, t4, t4), {
                       "obj_one_card": float(r1.obj),
                       "status_one_card": int(r1.status),
                       "eta_one_card": float(r1.eta), "obj_rel": obj_rel,
                       "tol": 1e-6}, ok)

    # sharded q^4 SOS-dual operator
    nn = 2 + q + q * q
    M = rng.standard_normal((nn, nn))
    M = M + M.T
    sop = ShardedSymDualOp(q, mesh)
    top, rowsQ = sop.split_matrix(M)
    t0 = time.perf_counter()
    ys = jax.block_until_ready(sop.apply(top, rowsQ))
    t_app = time.perf_counter() - t0
    W_top, W_rows = sop.adjoint(ys)
    y_ref = symdual._apply_tensor(jnp.asarray(M), q)
    W_ref = np.asarray(symdual._adjoint_tensor(*y_ref, q))
    keep = _sos_flat_rows(q) >= 0
    y_flat = np.concatenate([np.ravel(np.asarray(v)) for v in ys])
    r_flat = np.concatenate([np.ravel(np.asarray(v)) for v in y_ref])
    apply_rel = rel(y_flat[keep], r_flat[keep])
    adjoint_rel = rel(sop.merge_matrix(W_top, W_rows), W_ref)
    ok = apply_rel <= 1e-10 and adjoint_rel <= 1e-10
    ok_all &= emit(f"four_sharded_symdual_q{q}", {"wall_s": t_app}, {
        "apply_rel": apply_rel, "adjoint_rel": adjoint_rel, "tol": 1e-10,
        "shardings": _sharding_report(rowsQ=rowsQ, Y4=ys[4],
                                      W_rows=W_rows)}, ok)
    return ok_all


# -- main ------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the mesh-sharded paths on four GPUs")
    args = ap.parse_args(argv)
    dev = require_gpu()
    import jax
    if args.four and len(jax.devices()) != 4:
        sys.stderr.write(f"chip_smoke --four: need 4 GPUs, found "
                         f"{len(jax.devices())}\n")
        sys.exit(2)
    C_torus = torus_class()
    if args.four:
        ok = phase_four(C_torus)
    else:
        C_g1 = g1_class()
        ok = phase_ops(C_torus, C_g1)
        ok = phase_maxcut_g1(C_g1) and ok
        ok = phase_maxcut_torus(C_torus) and ok
        ok = phase_mc() and ok
        ok = phase_bqp_dual() and ok
    for ln in card_lines():
        print(f"card: {ln}", flush=True)
    if not ok:
        sys.stderr.write("chip_smoke: a check failed\n")
        sys.exit(1)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
