"""Operators for the dual (Riemannian-ADMM) drivers.

The dual drivers (src/dual/ManiDSDP*.m) factor the SLACK matrix
S = Y'Y and recover the primal X from multipliers.  Unlike the primal
side, the ADMM multiplier x and the gradient matrix are inherently
dense n x n objects (the reference stores x = zeros(n^2,1),
ManiDSDP_unitdiag.m:46), and the hot products 2*Y*X are dense matmuls.
The constraint operator A and the free-variable block B stay sparse
(COO + gather/segment-sum).

Key invariant inherited from the reference: A*A' must be DIAGONAL
(true for the SOS bases emitted by bqpsos/qssos), which makes the
y-step an exact closed-form least squares y = (AA')^{-1} A (S(:)-c)
(ManiDSDP_unitdiag.m:39-41,74).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SparseMat:
    """General sparse matrix (rows x cols) with both orderings.

    ``*_r`` arrays are sorted by row (for M @ v), ``*_c`` by column
    (for M.T @ u)."""
    row_r: jax.Array
    col_r: jax.Array
    val_r: jax.Array
    row_c: jax.Array
    col_c: jax.Array
    val_c: jax.Array
    nrows: int = dataclasses.field(metadata=dict(static=True))
    ncols: int = dataclasses.field(metadata=dict(static=True))

    @staticmethod
    def from_scipy(M) -> "SparseMat":
        import scipy.sparse as sp
        coo = sp.coo_matrix(M)
        orow = np.lexsort((coo.col, coo.row))
        ocol = np.lexsort((coo.row, coo.col))
        return SparseMat(
            row_r=jnp.asarray(coo.row[orow], dtype=jnp.int32),
            col_r=jnp.asarray(coo.col[orow], dtype=jnp.int32),
            val_r=jnp.asarray(coo.data[orow], dtype=jnp.float64),
            row_c=jnp.asarray(coo.row[ocol], dtype=jnp.int32),
            col_c=jnp.asarray(coo.col[ocol], dtype=jnp.int32),
            val_c=jnp.asarray(coo.data[ocol], dtype=jnp.float64),
            nrows=int(M.shape[0]), ncols=int(M.shape[1]))

    def matvec(self, v):
        return jax.ops.segment_sum(
            self.val_r * jnp.take(v, self.col_r), self.row_r,
            num_segments=self.nrows, indices_are_sorted=True)

    def rmatvec(self, u):
        return jax.ops.segment_sum(
            self.val_c * jnp.take(u, self.row_c), self.col_c,
            num_segments=self.ncols, indices_are_sorted=True)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DualOp:
    """Dual-form data: sup <C,X>+<c,w> s.t. A(X)+B(w)=b, X psd, w free.

    A is the PSD-block operator (m x n^2), B the free block (m x f).
    Entries of A are (k, lin) with lin = i*n + j row-major into a dense
    n x n matrix; both (sorted-by-k, sorted-by-lin) orderings are kept
    for forward/adjoint.
    """
    # A sorted by constraint row k (forward A(M))
    k_r: jax.Array
    lin_r: jax.Array
    v_r: jax.Array
    # A sorted by lin (adjoint scatter mat(A'y))
    k_c: jax.Array
    lin_c: jax.Array
    v_c: jax.Array
    B: SparseMat
    b: jax.Array               # (m,)
    cf: jax.Array              # (f,) free-part cost
    C: jax.Array               # (n, n) dense PSD-part cost
    idAAt: jax.Array           # (m,) 1 / diag(A A')
    bA: jax.Array              # (n, n) dense mat(A' D^{-1} b)
    Ac: jax.Array              # (m,)  A @ vec(C)
    m: int = dataclasses.field(metadata=dict(static=True))
    n: int = dataclasses.field(metadata=dict(static=True))
    f: int = dataclasses.field(metadata=dict(static=True))

    @staticmethod
    def build(A, b, c, n: int, f: int = 0, dAAt=None,
              ns=None) -> "DualOp":
        """A: (m, f + n^2) scipy sparse, SeDuMi dual layout (free block
        first, ManiDSDP_unitdiag.m:34-37); c likewise; vec is
        column-major (MATLAB).

        Multiblock (``ns`` given): the PSD columns hold the stacked
        per-block vecs; they are remapped into the flat N = sum(n_i)
        column space (global block-diagonal (i, j) indices), and ``n``
        is ignored in favor of N.
        """
        import scipy.sparse as sp
        A = sp.csr_matrix(A)
        m = A.shape[0]
        c = np.asarray(c, dtype=np.float64).ravel()
        cf = c[:f]
        cs = c[f:]
        B = A[:, :f].tocoo()
        Ap = A[:, f:].tocoo()

        kk = Ap.row.astype(np.int64)
        lin_cm = Ap.col.astype(np.int64)          # column-major stacked
        if ns is not None:
            nsa = np.asarray(ns, dtype=np.int64)
            off = np.concatenate([[0], np.cumsum(nsa)])
            off2 = np.concatenate([[0], np.cumsum(nsa ** 2)])
            n = int(off[-1])

            def to_ij(lin_idx):
                bl = np.searchsorted(off2, lin_idx, side="right") - 1
                loc = lin_idx - off2[bl]
                return loc % nsa[bl] + off[bl], loc // nsa[bl] + off[bl]

            ii, jj = to_ij(lin_cm)
            # dense C from stacked block vecs
            cs_full = np.zeros((n, n))
            cl = np.nonzero(cs)[0].astype(np.int64)
            ci, cjj = to_ij(cl)
            np.add.at(cs_full, (ci, cjj), cs[cl])
            cs = cs_full.flatten(order="F")
        else:
            ii = lin_cm % n
            jj = lin_cm // n
        lin = ii * n + jj                          # row-major for device
        vv = Ap.data.astype(np.float64)

        if dAAt is None:
            dAAt = np.zeros(m)
            np.add.at(dAAt, kk, vv * vv)
        else:
            dAAt = np.asarray(dAAt, dtype=np.float64).ravel()
        idAAt = 1.0 / dAAt

        orow = np.argsort(kk, kind="stable")
        ocol = np.argsort(lin, kind="stable")

        C = cs.reshape(n, n, order="F")
        bAv = vv * (b.ravel()[kk] * idAAt[kk])
        bA = np.zeros(n * n)
        np.add.at(bA, lin, bAv)
        Ac = np.zeros(m)
        np.add.at(Ac, kk, vv * C.reshape(-1)[lin])

        return DualOp(
            k_r=jnp.asarray(kk[orow], dtype=jnp.int32),
            lin_r=jnp.asarray(lin[orow]),
            v_r=jnp.asarray(vv[orow]),
            k_c=jnp.asarray(kk[ocol], dtype=jnp.int32),
            lin_c=jnp.asarray(lin[ocol]),
            v_c=jnp.asarray(vv[ocol]),
            B=SparseMat.from_scipy(B),
            b=jnp.asarray(np.asarray(b, dtype=np.float64).ravel()),
            cf=jnp.asarray(cf),
            C=jnp.asarray(C),
            idAAt=jnp.asarray(idAAt),
            bA=jnp.asarray(bA.reshape(n, n)),
            Ac=jnp.asarray(Ac),
            m=m, n=n, f=int(f))

    # ---- operators on dense n x n matrices -----------------------------
    def apply(self, M):
        """A(vec(M)) -> (m,) for dense M."""
        vals = jnp.take(M.reshape(-1), self.lin_r)
        return jax.ops.segment_sum(self.v_r * vals, self.k_r,
                                   num_segments=self.m,
                                   indices_are_sorted=True)

    def adjoint(self, y):
        """mat(A'y) -> dense (n, n)."""
        flat = jnp.zeros(self.n * self.n, dtype=y.dtype)
        flat = flat.at[self.lin_c].add(
            self.v_c * jnp.take(y, self.k_c),
            indices_are_sorted=True, unique_indices=False)
        return flat.reshape(self.n, self.n)

    def y_step(self, S):
        """Closed-form y = (AA')^{-1} A (S(:) - c)  (ManiDSDP_unitdiag.m:74)."""
        return self.idAAt * (self.apply(S) - self.Ac)
