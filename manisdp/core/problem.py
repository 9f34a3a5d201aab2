"""Problem / options / result containers for the RTR core.

The reference's cost/grad/hess callbacks communicate through MATLAB
closure variables whose validity depends on Manopt's call ordering
(SURVEY §2.1; e.g. src/primal/ManiSDP_unitdiag.m:152-171).  Here the
data flow is explicit:

    cost(Y, params)            -> (f, aux)
    grad(Y, params, aux)       -> (g, gaux)
    hess(Y, U, params, aux, gaux) -> H

``params`` is a pytree of runtime solver state (multipliers y, penalty
sigma, problem data refs); ``aux`` carries cost-time byproducts the
gradient needs (e.g. the AL residual Axb); ``gaux`` carries grad-time
byproducts the Hessian needs (e.g. eS, Y.*eG sums).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple


@dataclasses.dataclass(frozen=True)
class Problem:
    manifold: Any                       # a Manifold class (static)
    cost: Callable[..., Any]            # (Y, params) -> (f, aux)
    grad: Callable[..., Any]            # (Y, params, aux) -> (g, gaux)
    hess: Callable[..., Any]            # (Y, U, params, aux, gaux) -> H


@dataclasses.dataclass(frozen=True)
class TROptions:
    """Static trust-region options (manopt trustregions.m:339-351)."""
    maxiter: int = 4
    maxinner: int = 20
    mininner: int = 1
    tolgradnorm: float = 1e-8
    kappa: float = 0.1
    theta: float = 1.0
    rho_prime: float = 0.1
    rho_regularization: float = 1e3
    # Run the truncated-CG INNER loop (the Hessian-product hot loop) in
    # this dtype while the outer RTR quantities (cost, gradient, rho
    # test, gradnorm stopping) stay in the ambient dtype.  "float32"
    # makes the tCG an inexact-Newton model solve (trust regions
    # tolerate inexact Hessians) — certification is untouched
    # because dinf/gap/pinf never see tCG internals.  None = ambient.
    # f32 products run at HIGHEST precision (package __init__), so
    # a GPU does not silently drop them to TF32.
    tcg_dtype: str | None = None
    # f32 tCG cannot push the RELATIVE residual below ~1e-7, so the
    # kappa/theta target is floored there to avoid burning maxinner
    # iterations on unreachable targets.
    tcg_resid_floor: float = 3e-7


class TRResult(NamedTuple):
    Y: Any
    fx: Any
    norm_grad: Any
    iters: Any          # accepted+rejected TR iterations executed
    inner_iters: Any    # total tCG iterations == Hessian-vector products
