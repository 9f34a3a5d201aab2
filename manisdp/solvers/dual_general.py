"""sup <C,X>+<c,w> s.t. A(X)+B(w)=b, X>=0 — JAX equivalent of
src/dual/ManiDSDP.m (Euclidean slack factor + Riemannian ADMM with the
composite x-update through iAB = A' (AA')^{-1} B).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.sparse as sp

from ..config import SolverOptions
from ..ops.dualops import DualOp, SparseMat
from .common import SDPResult
from .dual_al import solve_dual_al


def build_iab(A, n: int, f: int, dAAt=None) -> SparseMat:
    """iAB = A_psd' D^{-1} B as a sparse (n^2 x f) matrix with ROW-MAJOR
    flat row indices (device layout)."""
    A = sp.csr_matrix(A)
    B = A[:, :f]
    Ap = A[:, f:].tocoo()
    if dAAt is None:
        dAAt = np.zeros(A.shape[0])
        np.add.at(dAAt, Ap.row, Ap.data ** 2)
    D_inv = sp.diags(1.0 / np.asarray(dAAt, dtype=np.float64).ravel())
    M = (Ap.T @ (D_inv @ B)).tocoo()          # (n^2 cm, f)
    ii = M.row % n
    jj = M.row // n
    lin_rm = ii * n + jj
    M_rm = sp.coo_matrix((M.data, (lin_rm, M.col)), shape=(n * n, f))
    return SparseMat.from_scipy(M_rm)


def solve_dual_sdp(A, b, c, n: int, f: int = 0,
                   dAAt=None,
                   options: Optional[SolverOptions] = None,
                   Y0: Optional[np.ndarray] = None,
                   resume: Optional[str] = None,
                   **overrides) -> SDPResult:
    """SeDuMi dual layout: A (m, f + n^2) sparse, free block first.

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
    op = A if isinstance(A, DualOp) else DualOp.build(A, b, c, n, f, dAAt)
    iAB = build_iab(A, n, f, dAAt) if not isinstance(A, DualOp) else None
    return solve_dual_al("dual_general", op, options, iAB=iAB, Y0=Y0,
                         **kw, **overrides)
