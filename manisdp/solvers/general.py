"""min <C,X> s.t. A(X)=b, X>=0 — JAX equivalent of
src/primal/ManiSDP.m (Euclidean factory + AL, warm-startable).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..config import SolverOptions
from ..ops.sparse import ConstraintOp
from .common import SDPResult
from .primal_al import solve_primal_al


def solve_sdp(At, b, c, n: int,
              options: Optional[SolverOptions] = None,
              Y0: Optional[np.ndarray] = None,
              y0: Optional[np.ndarray] = None,
              mesh=None,
              resume: Optional[str] = None,
              **overrides) -> SDPResult:
    """SeDuMi-format input: At (n^2, m) sparse, b (m,), c (n^2,).

    ``resume``: path of a checkpoint_every snapshot; loads the
    factor/multipliers/penalty and continues that trajectory."""
    if resume:
        from ..utils.checkpoint import resume_kwargs
        rk = resume_kwargs(resume)
        Y0 = rk.get("Y0", Y0)
        y0 = rk.get("y0", y0)
        if "sigma0" in rk:
            overrides.setdefault("sigma0", rk["sigma0"])
    op = At if isinstance(At, ConstraintOp) else \
        ConstraintOp.build(At, b, c, n)
    return solve_primal_al("general", op, options, Y0=Y0, y0=y0, mesh=mesh,
                           **overrides)
