"""Solver options with per-variant defaults.

The reference configures each driver through an ``options`` struct whose
defaults differ per variant (e.g. src/primal/ManiSDP_unitdiag.m:10-26 vs
src/primal/ManiSDP.m:9-25).  We mirror that with one dataclass plus
per-variant default dictionaries; a solver merges ``DEFAULTS[variant]``
with user overrides.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class SolverOptions:
    """Options shared by every ManiSDP-JAX driver.

    Field semantics follow the reference (README.md:31-106 of the
    reference documents them per variant):

    - ``tol``: target on the max KKT residual eta = max(gap, pinf, dinf).
    - ``p0``: initial factor rank.
    - ``max_outer``: AL / ADMM outer-iteration cap (AL_maxiter / ADMM_maxiter).
    - ``sigma0 / sigma_min / sigma_max / gama``: penalty schedule.
    - ``theta``: singular-value cutoff for rank truncation.
    - ``delta``: max number of escape directions appended per iteration.
    - ``alpha``: escape step size (when line_search is off).
    - ``tolgradnorm / tr_maxinner / tr_maxiter``: inner RTR budgets.
    - ``tau1 / tau2``: pinf-vs-gradnorm thresholds for the sigma update.
    - ``line_search``: use backtracking saddle-escape line search.
    """

    tol: float = 1e-8
    p0: int = 2
    max_outer: int = 300
    sigma0: float = 1e-3
    sigma_min: float = 1e-2
    sigma_max: float = 1e7
    gama: float = 2.0
    theta: float = 1e-3
    delta: int = 8
    alpha: float = 0.1
    tolgradnorm: float = 1e-8
    tr_maxinner: int = 20
    tr_maxiter: int = 4
    tau1: float = 1.0
    tau2: float = 1.0
    line_search: bool = False
    min_facsize: int = 2          # multiblock: blocks below this stay full-rank
    seed: int = 0
    verbose: bool = True
    # Rank-padding bucket: p is padded up to a multiple of this so XLA
    # recompiles only when the bucket grows.  Not measured on H100.
    p_bucket: int = 8
    # Certificate eigensolver: "eigh" (full dense, one device f64
    # eigh) or "lobpcg" (partial, for large n); "auto" switches on n.
    eig_method: str = "auto"
    eig_switch_n: int = 1024      # n above which "auto" uses lobpcg
    #                               (crossover not measured on H100)
    # Partial-eigensolver implementation:
    #   "devrr" = fully device-resident row-layout LOBPCG (one dispatch
    #             per certificate call: Lanczos bounds, deflation
    #             whitening, the LOBPCG while_loop with on-device
    #             3b x 3b Rayleigh-Ritz, residual-backed bounds).
    #   "rowrr" = row-layout LOBPCG with host Rayleigh-Ritz
    #             (ops/eigs_rr.RowCertSolver; ~3 host round trips per
    #             LOBPCG iteration).
    #   "lobpcg" = the jax lobpcg_standard path (kept for the
    #             mesh-sharded cert).
    cert_method: str = "devrr"
    # LOBPCG certificate budgets: the warm-started cert (X0 carried
    # across outer iterations) uses the cheap budget; the full budget is
    # paid only when the conservative bound fails to certify tol but the
    # optimistic Ritz value would pass (i.e. exactly when accuracy
    # decides convergence).  Certification stays sound either way: the
    # reported dinf uses residual-backed lower bounds.
    lobpcg_maxiter: int = 400
    lobpcg_maxiter_warm: int = 80
    # Certificate precision: "float32" runs the bulk of the LOBPCG
    # iterations in f32 (HIGHEST matmul precision) with f64 polish; the
    # reported dinf bound is ALWAYS the f64 residual-backed one, so a
    # weak f32 stage can only be conservative.  "auto": f32 pre-stage
    # ON for cert_method=rowrr, OFF for the lobpcg path.
    cert_pre_dtype: str = "auto"
    lobpcg_refine: int = 16
    # Adaptive certificate budget: while the iterate is far from
    # convergence (max(gap, pinf) > cert_cheap_eta) the certificate
    # cannot decide convergence — only the escape directions and the
    # printed dinf matter — so the warm-started eigensolve runs with the
    # cheap budget.  The reference pays a full eig every iteration
    # because dense CPU eig is cheap for it (ManiSDP.m:66); we do not
    # have to.  Budgets are runtime scalars (no recompile).
    cert_cheap_eta: float = 1e-5
    lobpcg_maxiter_cheap: int = 25
    # Raw-residual exit threshold of the certificate eigensolve
    # (relative to the spectral scale).  With the Kato-Temple corrected
    # bound, residuals of ~1e-9*scale already certify ~1e-17-level
    # lam_min accuracy; demanding 1e-10 raw residuals is unreachable on
    # clustered spectra and burns the full iteration budget for
    # nothing.
    cert_inner_tol: float = 1e-9
    # The deflation factor passed to the certificate is padded to a
    # multiple of this so the device-cert program compiles ONCE per run
    # even as the rank bucket grows.  Not measured on H100.
    cert_p_bucket: int = 48
    # Working-block budget of the accuracy-deciding host-RR certificate
    # retry (maxcut driver): a block wide enough to cover the near-null
    # cluster of the Gset torus class.
    cert_big_block: int = 96
    # Endgame TR-budget escalation: the reference's tiny TR budgets
    # (e.g. TR_maxiter=3) assume the subproblem is nearly solved each
    # outer iteration.  When the sigma controller freezes (pinf sits
    # between tau1*gradnorm and tau2*gradnorm) while gap/pinf are at
    # tolerance but dinf is not, the blocker is an under-resolved
    # subproblem; escalating the budget lets gradnorm drop so the
    # controller unfreezes.  Set endgame_boost=False for reference-exact
    # budgets.
    endgame_boost: bool = True
    boost_tr_maxiter: int = 30
    boost_tr_maxinner: int = 200
    boost_after: int = 5          # consecutive frozen-sigma endgame iters
    # Ramp-phase deep-solve trigger (round 5, q=100): a long rank ramp
    # can hover at the pinf ~ tau2*gradnorm controller boundary with
    # sigma toggling every iteration and the gap bouncing around 1e-3,
    # so NEITHER the frozen-sigma, eta-stagnation nor sigma_push
    # trigger ever fires and no deep solve collapses gradnorm — the AL
    # convergence event ("deep solve -> gradnorm collapses -> sigma
    # ramps -> pinf contracts superlinearly") never happens (observed
    # at q = 100: 82 outers, pinf 1800 -> 10, tier pinned to 0).  When
    # the BEST pinf has not halved for ramp_deep_after consecutive
    # tier-0 outers while gap <= ramp_deep_gap, force the deep tier;
    # the progress-gated decay returns to tier 0 as usual.
    # ramp_deep_after=0 disables.
    ramp_deep_after: int = 12
    ramp_deep_gap: float = 5e-2
    # Forced sigma escalation on pinf stagnation (round 5): the
    # tau1/tau2 pinf-vs-gradnorm controller can wander indefinitely at
    # sigma ~ sigma_min when the inner budget leaves gradnorm ~1e-1
    # while pinf is O(1) (observed 100+ outers at random bqp q=80,
    # where the reference's own escape hatch is a
    # per-instance tau2=10, example/dual/example_bqp_dual.m:36).  When
    # the gap is already small and pinf has not contracted by
    # sigma_push_ratio within sigma_push_after iterations of the last
    # sigma increase, force sigma *= gama: feasibility needs a larger
    # penalty regardless of what gradnorm is doing.
    sigma_push: bool = False
    sigma_push_after: int = 6
    sigma_push_ratio: float = 0.7
    sigma_push_gap: float = 1e-3
    dtype: str = "float64"
    # Inner-solve precision:
    #   "float64": reference-exact (default).
    #   "tcg32":   the truncated-CG hot loop (every Hessian-vector
    #              product) runs in float32 while cost/grad/rho/gradnorm
    #              stay f64 — an inexact-Newton model solve with NO
    #              effect on certification (dinf/gap/pinf never touch
    #              tCG internals).
    #   "mixed":   a full f32 RTR pre-stage down to mixed_tolgradnorm,
    #              then f64 refinement.
    # f32 products run at HIGHEST matmul precision (package __init__):
    # a GPU would otherwise run them in TF32.
    # Default: "float64" for the AL/ADMM drivers (the delicate sigma
    # controllers — e.g. unittrace's tau1=1e-5 — can run away when the
    # f32 direction quality collapses on very ill-conditioned
    # subproblems, observed on Hamming theta at sigma ~ 1e5); the
    # maxcut driver (no penalty controller) defaults to "tcg32", which
    # certifies identically.
    inner_dtype: str = "float64"
    mixed_tolgradnorm: float = 1e-5
    # Cost-matrix mode for the unit-diagonal (MaxCut) driver: dense
    # matmuls for small n; the O(nnz) gather/segment path once n^2
    # FLOPs outgrow them.  Dense iff n <= dense_cost_max_n or
    # n^2 <= dense_cost_nnz_factor * nnz.  Crossover not measured on
    # H100.
    dense_cost_max_n: int = 2048
    dense_cost_nnz_factor: int = 64
    # AL constraint-operator carriers: "auto" uses DENSE (n, n) pattern
    # carriers (matmuls + scalar gather/scatter of A entries) when
    # n <= dense_al_max_n, else the factored gather/segment path (the
    # only one that scales past n ~ 10^4 and the only one that
    # shards).  Crossover not measured on H100.
    al_op_mode: str = "auto"     # "auto" | "entrywise" | "dense" | "sparse"
    dense_al_max_n: int = 4096
    # Entrywise-sample specialization (matrix-completion class): when
    # every constraint touches a single entry / symmetric pair, "auto"
    # uses EntrywiseConstraintOp (dense masked carriers, zero
    # gather/scatter) up to this n (~6 dense n^2 f64 arrays of device
    # memory).  Not measured on H100.
    entrywise_al_max_n: int = 8192
    # In-run checkpointing: every ``checkpoint_every`` outer iterations
    # the driver snapshots (Y, multipliers, sigma, iteration) to
    # ``checkpoint_path`` via utils.checkpoint.save_state.  0 = off.
    checkpoint_every: int = 0
    checkpoint_path: Optional[str] = None

    def replace(self, **kw) -> "SolverOptions":
        return dataclasses.replace(self, **kw)


def merged_options(variant: str, options: Optional[SolverOptions] = None,
                   **overrides) -> SolverOptions:
    """Merge per-variant defaults with user overrides.

    ``options`` (if given) wins over the variant defaults only for fields
    the user explicitly passed via ``overrides``; passing a full
    SolverOptions uses it as-is.
    """
    if options is not None:
        return options.replace(**overrides) if overrides else options
    base = dataclasses.replace(SolverOptions(), **VARIANT_DEFAULTS[variant])
    return base.replace(**overrides) if overrides else base


# Per-variant defaults, matching the reference preamble of each driver.
VARIANT_DEFAULTS = {
    # src/primal/ManiSDP_onlyunitdiag.m:8-17
    "maxcut_unitdiag": dict(
        p0=2, max_outer=20, theta=1e-1, delta=8, alpha=0.5,
        tr_maxinner=100, tr_maxiter=40, line_search=False,
        inner_dtype="tcg32",
    ),
    # src/primal/ManiSDP_unitdiag.m:10-26
    "unitdiag": dict(
        p0=2, max_outer=300, gama=2.0, sigma0=1e-3, sigma_min=1e-2,
        sigma_max=1e7, theta=1e-3, delta=8, alpha=0.1,
        tr_maxinner=20, tr_maxiter=4, tau1=1.0, tau2=1.0, line_search=False,
    ),
    # src/primal/ManiSDP_unittrace.m:10-25
    "unittrace": dict(
        p0=1, max_outer=1000, gama=2.0, sigma0=1e1, sigma_min=1e2,
        sigma_max=1e7, theta=1e-2, delta=8, alpha=0.05,
        tr_maxinner=40, tr_maxiter=3, tau1=1e-5, tau2=1e-4, line_search=True,
    ),
    # src/primal/ManiSDP.m:9-25
    "general": dict(
        p0=1, max_outer=1000, gama=2.0, sigma0=1e-2, sigma_min=1e-1,
        sigma_max=1e7, theta=1e-2, delta=8, alpha=0.1,
        tr_maxinner=20, tr_maxiter=4, tau1=1e-2, tau2=1e-1, line_search=True,
    ),
    # src/primal/ManiSDP_multiblock.m:11-27
    "multiblock": dict(
        p0=1, max_outer=1000, gama=2.0, sigma0=1e-1, sigma_min=1e-2,
        sigma_max=1e7, theta=1e-2, delta=8, alpha=0.1,
        tr_maxinner=20, tr_maxiter=4, tau1=1e1, tau2=1e1, line_search=False,
        min_facsize=2,
    ),
    # src/dual/ManiDSDP_unitdiag.m:10-26  (p0 = ceil(log(m)) is applied
    # by the driver when p0 is None-like; we keep 0 as the sentinel)
    "dual_unitdiag": dict(
        p0=0, max_outer=300, gama=2.0, sigma0=1e-3, sigma_min=1e-3,
        sigma_max=1e7, theta=1e-3, delta=8, alpha=0.1,
        tr_maxinner=20, tr_maxiter=4, tau1=1e1, tau2=1e2, line_search=False,
    ),
    # src/dual/ManiDSDP.m:10-25
    "dual_general": dict(
        p0=1, max_outer=1000, gama=2.0, sigma0=1e-1, sigma_min=1e-2,
        sigma_max=1e7, theta=1e-2, delta=8, alpha=0.01,
        tr_maxinner=20, tr_maxiter=4, tau1=0.1, tau2=1.0, line_search=True,
    ),
    # src/dual/ManiDSDP_multiblock.m:12-28
    "dual_multiblock": dict(
        p0=1, max_outer=1000, gama=2.0, sigma0=1e-1, sigma_min=1e-2,
        sigma_max=1e7, theta=1e-2, delta=8, alpha=0.2,
        tr_maxinner=20, tr_maxiter=4, tau1=1e1, tau2=1e1, line_search=True,
        min_facsize=2,
    ),
}
