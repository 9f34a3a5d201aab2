"""sup <C,X>+<c,w> s.t. A(X)+B(w)=b, X>=0, diag(S)=1 — JAX equivalent
of src/dual/ManiDSDP_unitdiag.m (oblique slack factor + Riemannian ADMM).
Requires AA' diagonal (SOS bases); pass ``dAAt`` to skip recomputing it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..config import SolverOptions
from ..ops.dualops import DualOp
from .common import SDPResult
from .dual_al import solve_dual_al


def solve_dual_unitdiag(A, b, c, n: int, f: int = 0,
                        dAAt=None,
                        options: Optional[SolverOptions] = None,
                        Y0: Optional[np.ndarray] = None,
                        resume: Optional[str] = None,
                        **overrides) -> SDPResult:
    """SeDuMi dual layout: A (m, f + n^2) sparse with the free block
    first (ManiDSDP_unitdiag.m:34-37), b (m,), c (f + n^2,).

    ``resume``: path of a checkpoint_every snapshot; loads the factor,
    multipliers (Xm, w) and penalty and continues that trajectory."""
    kw = {}
    if resume:
        from ..utils.checkpoint import resume_kwargs
        rk = resume_kwargs(resume)
        Y0 = rk.get("Y0", Y0)
        kw = {k: rk[k] for k in ("Xm0", "w0") if k in rk}
        if "sigma0" in rk:
            overrides.setdefault("sigma0", rk["sigma0"])
    from ..ops.symdual import SymDualOp
    op = A if isinstance(A, (DualOp, SymDualOp)) \
        else DualOp.build(A, b, c, n, f, dAAt)
    return solve_dual_al("dual_unitdiag", op, options, Y0=Y0, **kw,
                         **overrides)


def solve_bqp_sos_dual(Q, e, q: int,
                       options: Optional[SolverOptions] = None,
                       **overrides) -> SDPResult:
    """One-call SOS dual of min x'Qx + e'x over {-1,1}^q via the
    gather-free expanded-basis tensor operator (ops/symdual.SymDualOp).

    Equivalent problem to assemble_bqpsos -> solve_dual_unitdiag
    (reference example/dual/example_bqp_dual.m:10-40) without a
    gather or scatter in the operator.  b is normalized by
    max|b| internally as the reference examples do; the returned
    ``obj`` is scaled BACK to the unnormalized problem.
    """
    import dataclasses
    from ..config import VARIANT_DEFAULTS
    from ..ops.symdual import SymDualOp
    op = SymDualOp.build_bqpsos(Q, e, q)
    maxb = float(np.max(np.abs(np.asarray(op.b))))
    op = dataclasses.replace(op, b=op.b / maxb, bA=op.bA / maxb)
    # reference p0 = ceil(log(#constraints)) (ManiDSDP_unitdiag.m:11);
    # the flat tensor length would inflate it
    overrides.setdefault("p0", max(int(np.ceil(np.log(op.m_true))), 1))
    # Exact-correspondence parameter mapping (see ops/symdual.py): on
    # the uniformly-duplicated basis every class size is 4x, so the
    # ADMM with sigma_e = sigma_ref/4 reproduces the reference
    # trajectory with cost values and rho tests IDENTICAL, gradients
    # and Hessians scaled by 1/2, step/Delta norms by sqrt(2)
    # (matching the sqrt(2) typicaldist), ||As|| by 2 and gradnorm by
    # 1/sqrt(2).  Hence tau thresholds scale by 2*sqrt(2) and
    # tolgradnorm by 1/sqrt(2).
    d = VARIANT_DEFAULTS["dual_unitdiag"]
    s2 = float(np.sqrt(2.0))
    overrides.setdefault("sigma0", d["sigma0"] / 4.0)
    overrides.setdefault("sigma_min", d["sigma_min"] / 4.0)
    overrides.setdefault("sigma_max", d["sigma_max"] / 4.0)
    overrides.setdefault("tau1", d["tau1"] * 2.0 * s2)
    # tau2: the reference's own large-q recipe drops tau2 to 10
    # (example/dual/example_bqp_dual.m:36, "% q = 80, i = 3") so sigma
    # ramps from the first iterations instead of freezing at sigma_min
    # while pinf is O(10-1000) — without it the q >= 70 ramp spends
    # 50 outers at sigma ~ 1e-3 growing the rank past 300 (observed
    # at q = 80)
    tau2_ref = 10.0 if q >= 70 else d["tau2"]
    overrides.setdefault("tau2", tau2_ref * 2.0 * s2)
    overrides.setdefault("tolgradnorm", 1e-8 / s2)
    # plateau-boost budget: deep enough to collapse gradnorm (~1e-9
    # observed at 1500 Hv) without the 30x200 default's cost — each
    # boosted iteration is pure q^4 tensor work
    overrides.setdefault("boost_tr_maxiter", 15)
    overrides.setdefault("boost_tr_maxinner", 100)
    # forced sigma escalation on pinf stagnation (config.py): the
    # random q >= 70 instances need the penalty to keep ramping even
    # while the inner budget leaves gradnorm O(1e-1) — the reference's
    # own recipe for this class is a per-instance tau2 drop
    # (example/dual/example_bqp_dual.m:36)
    overrides.setdefault("sigma_push", True)
    res = solve_dual_al("dual_unitdiag", op, options, **overrides)
    res.obj = res.obj * maxb
    return res
