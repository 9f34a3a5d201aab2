"""Per-workload tuned hyperparameter recipes.

The reference ships tuned per-workload settings in
``example/settings.txt:1-56`` (mc / bqp / qs / rs / stls) plus inline
tunings in the example scripts (example_theta.m:50-53,
example_maxcut.m:32, example_qsphere.m:23-25, example_stls.m:28-32,
example_matrixcompletion.m:52-58).  This module codifies them as
override dictionaries for :func:`manisdp.config.merged_options`,
so a user can reproduce the reference's benchmark configurations:

    from manisdp import recipes
    solver, overrides = recipes.recipe("mc")
    res = solve_general(At, b, c, n, **overrides)

Notes on the mapping:
  - settings.txt writes a single ``tau``; the drivers consume the pair
    (tau1, tau2).  Where the reference example scripts set tau1/tau2
    explicitly (example_qsphere.m:25, example_stls.m:31-32) we use
    those; otherwise both thresholds get the settings.txt value, which
    matches how a single tau behaves in the sigma controller.
  - conditional entries (e.g. qs sigma0 depends on the instance size d)
    are exposed via the optional ``size`` argument.
"""

from __future__ import annotations

from typing import Optional, Tuple

# workload -> (solver variant name, base overrides)
RECIPES = {
    # matrix completion (settings.txt:1-10; example_matrixcompletion.m:52-58)
    "mc": ("general", dict(
        sigma0=1e-2, sigma_min=1e-1, theta=1e-2, delta=10, alpha=0.1,
        tr_maxinner=6, tr_maxiter=8, tau1=1e-3, tau2=1e-3,
        line_search=False)),
    # moment relaxations of binary quadratic programs
    # (settings.txt:12-22; example_bqp.m)
    "bqp": ("unitdiag", dict(
        sigma0=1e-3, sigma_min=1e-2, theta=1e-3, delta=8, alpha=0.1,
        tr_maxinner=20, tr_maxiter=4, tau1=1.0, tau2=1.0,
        line_search=False)),
    # quartic minimization over the sphere (settings.txt:24-33;
    # example_qsphere.m:23-25 sets tau1=0.02 explicitly)
    "qs": ("general", dict(
        sigma0=1.0, sigma_min=1e-1, theta=1e-2, delta=6,
        tr_maxinner=20, tr_maxiter=4, tau1=2e-2, tau2=1e-1,
        line_search=True)),
    # rotation search / QUASAR (settings.txt:35-43;
    # example_rotationsearch.m)
    "rs": ("unittrace", dict(
        sigma0=1e1, sigma_min=1e2, theta=1e-2, delta=10,
        tr_maxinner=40, tr_maxiter=3, tau1=1.0 / 6e3, tau2=1.0 / 6e3,
        line_search=True)),
    # structured total least squares (settings.txt:45-54;
    # example_stls.m:28-32)
    "stls": ("general", dict(
        sigma0=1e-2, sigma_min=1e-1, theta=1e-1, delta=8, alpha=0.2,
        tr_maxinner=50, tr_maxiter=4, tau1=1e-2, tau2=1e2,
        line_search=False)),
    # Lovasz theta of random graphs (example_theta.m:50-53)
    "theta": ("unittrace", dict(
        sigma0=1e5, sigma_max=1e8, line_search=True)),
    # SDPLIB theta-class instances through the general driver (theta1,
    # theta2, ...): the default tiny TR budget stalls around 1e-5;
    # a moderately larger budget converges (measured on theta1).  For
    # theta2+ the big-sigma variant below converges in ~30 iterations.
    "theta_sdplib": ("general", dict(tr_maxiter=8, tr_maxinner=40)),
    "theta_sdplib_big": ("general", dict(
        tr_maxiter=10, tr_maxinner=60, sigma0=1e2, tau1=1e-3, tau2=1e-2)),
    # SDPLIB truss topology (LP cone + many small PSD blocks, solved
    # through solvers/dispatch.solve_sedumi's K.l folding — a class the
    # reference drivers cannot run): general-style sigma schedule with
    # a solid TR budget (measured truss1/3/4 converge < 60 iterations)
    "sdplib_truss": ("multiblock", dict(
        tr_maxiter=20, tr_maxinner=80, sigma0=1.0, sigma_min=1e-1,
        tau1=1e-2, tau2=1e-1)),
    # Gset MaxCut (example_maxcut.m:32)
    "maxcut": ("maxcut_unitdiag", dict(p0=40)),
}


def recipe(workload: str, size: Optional[int] = None) -> Tuple[str, dict]:
    """Return ``(solver_variant, option_overrides)`` for a workload.

    ``size`` resolves the size-conditional entries of settings.txt:
    qs uses sigma0=1 for d<=50 and 1e-2 above (settings.txt:25-26);
    bqp uses TR_maxinner=20 for d<=10 and 25 above (settings.txt:18-19).
    """
    if workload not in RECIPES:
        raise KeyError(
            f"unknown workload {workload!r}; known: {sorted(RECIPES)}")
    variant, base = RECIPES[workload]
    ov = dict(base)
    if size is not None:
        if workload == "qs" and size > 50:
            ov["sigma0"] = 1e-2
        if workload == "bqp" and size > 10:
            ov["tr_maxinner"] = 25
    return variant, ov
