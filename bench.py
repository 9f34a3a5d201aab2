#!/usr/bin/env python
"""Benchmark harness: per-workload JSON lines + a RUNNING suite-geomean
line after every row (the driver records the LAST complete JSON line,
so even a timeout-truncated run always carries a geomean).

Workloads (fastest-first so truncation keeps most rows):

  - maxcut_G1    : Gset G1 (n=800).  Baseline 3.0 s (Wang-Hu
                   J. Sci. Comput. 2025 Gset table, desktop CPU;
                   baseline_measured false).
  - mc_n2000/4000: trace-min matrix completion, MEASURED references
                   9.05 s / 48.7 s (data/results.txt:2,4).
  - maxcut_G67   : Gset G67 (n=10000), THREE in-process trials —
                   median reported, min/max in extra.  Baseline
                   240 s is a derived lower bound (BASELINE.md "G67
                   derivation").
  - bqp_q60_dual : SOS dual of BQP q=60 instance 1, tensor operator.
                   Baseline 134 s (data/dual.txt:16 row 1); NOTE
                   the reference's own ManiDSDP table reports 20.5 s
                   for d=60
                   (data/bqp_result.txt:26) — recorded in extra as
                   the strictest alternative.

Each workload runs TWICE in-process; the reported value is the SECOND
(warm) run's SOLVER-INTERNAL time (SDPResult.time — the reference
starts its clock inside the solver after assembly, ManiSDP.m:52, and
its published numbers exclude MATLAB JIT warmup likewise).  Metric
names carry the "warmsolve" tag to make that explicit.
The first (cold) run pays the compiles and is reported as
extra.cold_s.

BENCH_BUDGET_S (default 1500) bounds the suite: a workload whose
estimated cost exceeds the remaining budget is SKIPPED with an
explicit JSON row; the warm re-run is skipped when the budget cannot
fit it.  BENCH_SET=g1 runs only G1.
"""

import json
import os
import sys
import time

GSET = os.environ.get("BENCH_GSET_DIR", "/root/reference/data/Gset")
DATA = os.environ.get("BENCH_DATA_DIR", "/root/reference/data")
BENCH_SET = os.environ.get("BENCH_SET", "full")
BUDGET_S = float(os.environ.get("BENCH_BUDGET_S", "4200"))
T0 = time.time()

# a warm run re-executes the solve with every program compiled; the
# dominant cold cost is compiles, so estimate warm at this fraction
WARM_FRACTION = float(os.environ.get("BENCH_WARM_FRACTION", "0.6"))

ROWS = []


def _timed_runs(solve):
    """Cold run + (budget permitting) warm run.  Returns
    (reported_seconds, res, cold_seconds, warm)."""
    t0 = time.time()
    res = solve()
    cold = time.time() - t0
    left = BUDGET_S - (time.time() - T0)
    if left < 1.15 * cold * WARM_FRACTION:
        return res.time, res, cold, False
    res = solve()
    return res.time, res, cold, True


def _emit(metric, seconds, baseline, res, measured_baseline, extra=None):
    out = {
        "metric": metric,
        "value": round(seconds, 4),
        "unit": "s",
        "vs_baseline": round(baseline / seconds, 3),
        "extra": {
            "obj": float(res.obj),
            "eta": float(getattr(res, "eta", res.dinf)),
            "status": int(res.status),
            "outer_iters": int(res.iterations),
            "rtr_iters": int(res.rtr_iters),
            "hess_calls": int(res.hess_calls),
            "timers": {k: round(v, 2) for k, v in (res.timers or {}).items()},
            "baseline_s": baseline,
            "baseline_measured": measured_baseline,
            **(extra or {}),
        },
    }
    print(json.dumps(out), flush=True)
    ROWS.append(out)
    _emit_geomean()
    return out


def _emit_geomean():
    """Running geomean row — re-emitted after every workload so the
    LAST complete JSON line is always the current suite summary."""
    if not ROWS:
        return
    geo = 1.0
    for r in ROWS:
        geo *= r["vs_baseline"]
    geo = geo ** (1.0 / len(ROWS))
    print(json.dumps({
        "metric": "suite_geomean_speedup_vs_reference",
        "value": round(geo, 3),
        "unit": "x",
        "vs_baseline": round(geo, 3),
        "extra": {"n_workloads": len(ROWS), "workloads": {
            r["metric"]: {"s": r["value"],
                          "vs_baseline": r["vs_baseline"],
                          "status": r["extra"]["status"],
                          "baseline_measured":
                              r["extra"]["baseline_measured"]}
            for r in ROWS}},
    }), flush=True)


def bench_maxcut(graph, baseline, measured, trials=1):
    from manisdp import solve_maxcut_unitdiag
    from manisdp.frontends.gset import maxcut_cost
    C = maxcut_cost(os.path.join(GSET, f"{graph}.txt"))
    solve = lambda: solve_maxcut_unitdiag(C, p0=40, verbose=False)
    dt, res, cold, warm = _timed_runs(solve)
    times = [dt]
    for _ in range(trials - 1):
        left = BUDGET_S - (time.time() - T0)
        if left < 1.3 * dt:
            break
        r2 = solve()
        times.append(r2.time)
        if r2.time <= sorted(times)[len(times) // 2]:
            res = r2
    times_s = sorted(times)
    med = times_s[len(times_s) // 2]
    extra = {"rtr_iters_per_s": round(res.rtr_iters / med, 2),
             "cold_s": round(cold, 2), "warm_run": warm}
    if len(times) > 1:
        extra["trials_s"] = [round(t, 2) for t in times]
        extra["trial_min_s"] = round(times_s[0], 2)
        extra["trial_max_s"] = round(times_s[-1], 2)
    return _emit(f"maxcut_{graph}_warmsolve_to_kkt1e-8", med, baseline,
                 res, measured, extra=extra)


def bench_mc(p=1000, baseline=9.05):
    """p = q = half the SDP size; reference construction exactly
    (rank 10, m = 400 * (p + q) entry samples, seed 3)."""
    from manisdp import solve_sdp
    from manisdp.frontends.workloads import matrix_completion
    from manisdp.recipes import recipe
    data, _ = matrix_completion(p, p, rank=10, m_samples=400 * 2 * p,
                                seed=3)
    _, kw = recipe("mc")
    kw = dict(kw, delta=10, tr_maxinner=6, tr_maxiter=8, theta=1e-2,
              inner_dtype="tcg32")
    dt, res, cold, warm = _timed_runs(
        lambda: solve_sdp(data.At, data.b, data.c, data.K.s,
                          verbose=False, **kw))
    return _emit(f"mc_n{2 * p}_warmsolve_to_kkt1e-8", dt, baseline, res,
                 True, extra={"cold_s": round(cold, 2), "warm_run": warm})


def _bqp_instance(q):
    import numpy as np
    fq = os.path.join(DATA, f"bqp_Q_{q}_1.txt")
    if os.path.exists(fq):
        Q = np.loadtxt(fq, delimiter=",")
        e = np.loadtxt(os.path.join(DATA, f"bqp_e_{q}_1.txt"),
                       delimiter=",")
    else:
        # the reference ships instances only up to q = 60; its q >= 70
        # table rows are random draws of the same class
        # (example/example_bqp.m) — generate the matching class
        rng = np.random.default_rng(1)
        Q = rng.standard_normal((q, q))
        Q = (Q + Q.T) / 2.0
        e = rng.standard_normal(q)
    return Q, e


def bench_bqp_dual(q, baseline, alt_baselines, p_bucket=192):
    from manisdp.solvers.dual_unitdiag import solve_bqp_sos_dual
    Q, e = _bqp_instance(q)
    # p_bucket=192: ONE rank-bucket shape for the whole q=60 ramp
    # (peak p ~ 150) — the q^4 tensor work dominates every program, so
    # the larger factor buffers cost nothing at runtime while cutting
    # the fresh-container compile count ~3x (the cold run is
    # compile-dominated at ~385 s with 64-buckets)
    kw = dict(line_search=True, verbose=False, inner_dtype="tcg32",
              p_bucket=p_bucket)
    dt, res, cold, warm = _timed_runs(
        lambda: solve_bqp_sos_dual(Q, e, q, **kw))
    return _emit(f"bqp_q{q}_dual_warmsolve_to_kkt1e-8", dt, baseline,
                 res, True,
                 extra={"n_expanded": 2 + q + q * q,
                        "alt_baselines_s": alt_baselines,
                        "cold_s": round(cold, 2), "warm_run": warm})


def bench_bqp_primal(q, baseline):
    """Primal moment-SDP (bqpmom class) via the expanded tensor
    operator (ops/symmom.py) — the reference's flagship primal
    workload, MEASURED 178 s at q = 60 instance 1 (data/primal.txt:16,
    ManiSDP_unitdiag on bqpmom; example/example_bqp.m:10-15)."""
    from manisdp.solvers.primal_mom import solve_bqp_mom
    Q, e = _bqp_instance(q)
    # p_bucket=192: one rank-bucket shape for the whole ramp (peak
    # p ~ 170) — each bucket transition compiles new programs
    kw = dict(verbose=False, inner_dtype="tcg32", p_bucket=192)
    dt, res, cold, warm = _timed_runs(
        lambda: solve_bqp_mom(Q, e, q, **kw))
    return _emit(f"bqp_q{q}_primal_warmsolve_to_kkt1e-8", dt, baseline,
                 res, True,
                 extra={"n_expanded": 2 + q + q * q,
                        "cold_s": round(cold, 2), "warm_run": warm})


def main():
    def run(fn, est_s, *args, **kwargs):
        left = BUDGET_S - (time.time() - T0)
        if est_s > left:
            print(json.dumps({
                "metric": f"{fn.__name__}_SKIPPED",
                "reason": f"estimated {est_s:.0f}s exceeds remaining "
                          f"budget {left:.0f}s "
                          f"(BENCH_BUDGET_S={BUDGET_S:.0f})",
            }), flush=True)
            _emit_geomean()
            return
        try:
            fn(*args, **kwargs)
        except Exception as e:          # pragma: no cover
            print(json.dumps({"metric": f"{fn.__name__}_FAILED",
                              "error": repr(e)[:200]}), flush=True)
            _emit_geomean()

    if BENCH_SET == "g1":
        run(bench_maxcut, 30, "G1", 3.0, False)
    else:
        run(bench_maxcut, 60, "G1", 3.0, False)
        run(bench_mc, 100, 1000, 9.05)
        run(bench_mc, 180, 2000, 48.7)
        run(bench_maxcut, 260, "G67", 240.0, False, trials=3)
        run(bench_bqp_dual, 450, 60, 134.0,
            {"dual_txt_row2": 37.0, "manidsdp_table_d60": 20.5})
        run(bench_bqp_primal, 550, 60, 178.0)
        # q = 80 SOS dual: m = 1.67M — the reference's own table
        # measures 322 s (data/bqp_result.txt:27); unreachable for the
        # repo before round 5 (r4: status 1 at 2,077 s)
        run(bench_bqp_dual, 1300, 80, 322.0,
            {"manidsdp_table_d80": 322.0}, p_bucket=128)
    if not ROWS:
        print(json.dumps({"metric": "bench_failed", "value": 0.0,
                          "unit": "x", "vs_baseline": 0.0}))


if __name__ == "__main__":
    sys.exit(main())
