"""Sparse operators on Burer-Monteiro factors — the device hot path.

The reference's hot ops are MATLAB sparse BLAS: ``Y*C`` (sparse cost
matrix), ``A*x``, ``At*v`` and ``A'*(At'*vec(Y'U))`` with A an m-by-n^2
sparse constraint matrix (SURVEY §3.2).  Here everything acts directly on
the factor ``Y`` (p, n) — X = Y'Y is never materialized — via
gather / elementwise / segment-sum chains that XLA fuses:

  A(YY')_k      = sum_e v_e <Y[:,i_e], Y[:,j_e]>      (pair_dots + segment by k)
  mat(A'w) on P = segment of v_e * w_k by pattern id   (a2p map)
  Y @ mat(vals) = segment of vals_e * Y[:,i_e] by j_e  (gather_cols + scatter_cols)

All index arrays are int32, value arrays float64, entries pre-sorted on
host so segment sums can claim sorted indices.  Data containers are
frozen dataclass pytrees: index/value arrays are leaves (device
resident), sizes are static metadata.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np


def gather_cols(Y, idx):
    """Columns of Y (p, n) at idx (nnz,) -> (nnz, p)."""
    return jnp.take(Y.T, idx, axis=0)


def pair_dots(Y, U, i, j):
    """<Y[:,i_e], U[:,j_e]> for each entry e -> (nnz,)."""
    return jnp.sum(gather_cols(Y, i) * gather_cols(U, j), axis=1)


def scatter_cols(vals, src_idx, out_idx, Y, n, sorted_out=True):
    """sum_e vals_e * Y[:, src_idx_e] scattered into column out_idx_e.

    Returns a (p, n) array: the factored form of ``Y @ M`` for a sparse
    matrix M with entries M[src, out] = vals.
    """
    contrib = gather_cols(Y, src_idx) * vals[:, None]          # (nnz, p)
    out = jax.ops.segment_sum(contrib, out_idx, num_segments=n,
                              indices_are_sorted=sorted_out)   # (n, p)
    return out.T


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SymCOO:
    """Symmetric n-by-n sparse matrix, full (both-triangles) COO pattern.

    Entries sorted by column j (the scatter target of right-multiply).
    """
    i: jax.Array
    j: jax.Array
    v: jax.Array
    n: int = dataclasses.field(metadata=dict(static=True))

    @staticmethod
    def from_scipy(mat) -> "SymCOO":
        import scipy.sparse as sp
        coo = sp.coo_matrix(mat)
        order = np.lexsort((coo.row, coo.col))
        return SymCOO(
            i=jnp.asarray(coo.row[order], dtype=jnp.int32),
            j=jnp.asarray(coo.col[order], dtype=jnp.int32),
            v=jnp.asarray(coo.data[order], dtype=jnp.float64),
            n=int(mat.shape[0]))

    @property
    def nnz(self) -> int:
        return self.v.shape[0]

    def matmat(self, Y):
        """Y @ C for Y (p, n): out[:, j] += v * Y[:, i]."""
        return scatter_cols(self.v, self.i, self.j, Y, self.n)

    def matmat_vals(self, Y, vals):
        """Y @ M where M has this pattern but values ``vals``."""
        return scatter_cols(vals, self.i, self.j, Y, self.n)

    def matvec_block(self, V, vals=None):
        """C @ V for a dense (n, k) block V — the eigensolver matvec."""
        v = self.v if vals is None else vals
        contrib = jnp.take(V, self.i, axis=0) * v[:, None]     # (nnz, k)
        return jax.ops.segment_sum(contrib, self.j, num_segments=self.n,
                                   indices_are_sorted=True)

    def quad_cols(self, Y, U=None):
        """Column sums of (Y'U) .* C -> z_j = sum_i C[i,j] <Y:,i, U:,j>."""
        U = Y if U is None else U
        e = pair_dots(Y, U, self.i, self.j)
        return jax.ops.segment_sum(self.v * e, self.j, num_segments=self.n,
                                   indices_are_sorted=True)

    def quad_form(self, Y, U=None):
        """<C, Y'U> = sum_ij C[i,j] <Y:,i, U:,j> (a scalar)."""
        U = Y if U is None else U
        e = pair_dots(Y, U, self.i, self.j)
        return jnp.dot(self.v, e)

    def to_dense(self):
        out = jnp.zeros((self.n, self.n), dtype=self.v.dtype)
        return out.at[self.i, self.j].add(self.v)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ConstraintOp:
    """The affine operator A : S^n -> R^m in factored-entry form.

    Stores every nonzero of the m-by-n^2 SeDuMi constraint matrix as
    (k, i, j, v) with entries sorted by constraint row k, plus:

    - ``pat``: the union sparsity pattern P of {c} U {rows of A} as a
      SymCOO *without* values (its ``v`` holds c restricted to P so the
      gradient matrix eS = mat(c + sigma*A'w) reuses it);
    - ``a2p``: map from A-entry -> index in P, so A'w restricted to P is
      one segment-sum.

    This factored representation is what makes grad/hess matrix-free:
    eS never exists as an n-by-n dense array unless n is small.
    """
    k: jax.Array         # (nnzA,) int32, sorted ascending
    i: jax.Array
    j: jax.Array
    v: jax.Array         # (nnzA,) float64
    a2p: jax.Array       # (nnzA,) int32 index into pattern P
    pat: SymCOO          # pattern P with v = c restricted to P
    b: jax.Array         # (m,) float64 right-hand side
    # second ordering, sorted by pattern id: lets the adjoint's
    # segment-sum claim sorted indices (memory-for-speed; the adjoint
    # runs twice per Hessian-vector product, SURVEY §3.2)
    kp: jax.Array        # (nnzA,) int32 constraint row, a2p-sorted
    vp: jax.Array        # (nnzA,) float64 values, a2p-sorted
    a2p_sorted: jax.Array  # (nnzA,) int32, ascending
    m: int = dataclasses.field(metadata=dict(static=True))
    n: int = dataclasses.field(metadata=dict(static=True))

    @staticmethod
    def build(At, b, c, n: int) -> "ConstraintOp":
        """From SeDuMi data: At (n^2, m) sparse, b (m,), c (n^2,).

        Host-side construction (runs once per problem).
        """
        import scipy.sparse as sp
        A = sp.csr_matrix(At.T) if not sp.issparse(At) else At.T.tocsr()
        m = A.shape[0]
        coo = A.tocoo()
        kk = coo.row.astype(np.int64)
        lin = coo.col.astype(np.int64)          # index into vec(X), col-major
        ii = (lin % n).astype(np.int64)
        jj = (lin // n).astype(np.int64)
        vv = coo.data.astype(np.float64)

        c = np.asarray(c).ravel().astype(np.float64)
        c_sp = sp.coo_matrix(c.reshape(n, n, order="F"))
        return ConstraintOp._assemble(
            kk, ii, jj, vv,
            c_sp.row.astype(np.int64), c_sp.col.astype(np.int64),
            c_sp.data.astype(np.float64), b, n, m)

    @staticmethod
    def build_multiblock(At, b, c, ns) -> "ConstraintOp":
        """Multi-block SeDuMi data: At (sum n_i^2, m) with blockwise
        column-major vec stacking (ManiSDP_multiblock.m:67-72).  The
        blocks collapse into a single (sum n_i)-column space: entry L
        of block bl at local (i, j) maps to global
        (off_bl + i, off_bl + j).  X stays block-diagonal because no
        constraint couples columns of different blocks.
        """
        import scipy.sparse as sp
        ns = np.asarray(ns, dtype=np.int64)
        off = np.concatenate([[0], np.cumsum(ns)])
        off2 = np.concatenate([[0], np.cumsum(ns ** 2)])
        N = int(off[-1])

        def to_global(lin):
            bl = np.searchsorted(off2, lin, side="right") - 1
            loc = lin - off2[bl]
            i = loc % ns[bl] + off[bl]
            j = loc // ns[bl] + off[bl]
            return i, j

        A = sp.csr_matrix(At.T) if not sp.issparse(At) else At.T.tocsr()
        m = A.shape[0]
        coo = A.tocoo()
        kk = coo.row.astype(np.int64)
        ii, jj = to_global(coo.col.astype(np.int64))
        vv = coo.data.astype(np.float64)

        c = np.asarray(c).ravel().astype(np.float64)
        cl = np.nonzero(c)[0].astype(np.int64)
        ci, cj = to_global(cl)
        return ConstraintOp._assemble(kk, ii, jj, vv, ci, cj, c[cl],
                                      b, N, m)

    @staticmethod
    def _assemble(kk, ii, jj, vv, ci, cj, cv, b, n, m) -> "ConstraintOp":
        import scipy.sparse as sp
        order = np.argsort(kk, kind="stable")
        kk, ii, jj, vv = kk[order], ii[order], jj[order], vv[order]

        # union pattern P, sorted by (j, i)
        keys_a = jj * n + ii
        keys_c = cj * n + ci
        pat_keys = np.unique(np.concatenate([keys_a, keys_c]))
        p_i = (pat_keys % n).astype(np.int32)
        p_j = (pat_keys // n).astype(np.int32)
        a2p = np.searchsorted(pat_keys, keys_a).astype(np.int32)
        c2p = np.searchsorted(pat_keys, keys_c)
        c_on_p = np.zeros(pat_keys.shape[0], dtype=np.float64)
        np.add.at(c_on_p, c2p, cv)

        pat = SymCOO(i=jnp.asarray(p_i), j=jnp.asarray(p_j),
                     v=jnp.asarray(c_on_p), n=n)
        perm = np.argsort(a2p, kind="stable")
        return ConstraintOp(
            k=jnp.asarray(kk, dtype=jnp.int32),
            i=jnp.asarray(ii, dtype=jnp.int32),
            j=jnp.asarray(jj, dtype=jnp.int32),
            v=jnp.asarray(vv, dtype=jnp.float64),
            a2p=jnp.asarray(a2p),
            pat=pat, b=jnp.asarray(b, dtype=jnp.float64).ravel(),
            kp=jnp.asarray(kk[perm], dtype=jnp.int32),
            vp=jnp.asarray(vv[perm], dtype=jnp.float64),
            a2p_sorted=jnp.asarray(a2p[perm]),
            m=int(m), n=int(n))

    @property
    def nnz(self) -> int:
        return self.v.shape[0]

    # -- forward operator ------------------------------------------------
    def pattern_pair_dots(self, Y, U=None):
        """e_P = <Y[:,i], U[:,j]> on the union pattern P -> (nnzP,)."""
        return pair_dots(Y, Y if U is None else U, self.pat.i, self.pat.j)

    def apply_from_e(self, e):
        """A(vec(M)) given M's values e on pattern P (via the a2p map)."""
        return jax.ops.segment_sum(
            self.v * jnp.take(e, self.a2p), self.k, num_segments=self.m,
            indices_are_sorted=True)

    def apply_factored(self, Y, U=None):
        """A(vec(Y'U)) -> (m,); U defaults to Y (then it is A(X)).

        Computes the p-length dots once per PATTERN entry and fans out
        to A-entries with a scalar gather — cheaper than per-A-entry
        gathers whenever nnz(A) > nnz(P).
        """
        return self.apply_from_e(self.pattern_pair_dots(Y, U))

    def apply_vec(self, x):
        """A @ x for a dense vec(X) (n^2,) — used off the hot path."""
        e = x[self.i.astype(jnp.int64) +
              self.j.astype(jnp.int64) * self.n]
        return jax.ops.segment_sum(self.v * e, self.k, num_segments=self.m,
                                   indices_are_sorted=True)

    # -- adjoint on the pattern ------------------------------------------
    def adjoint_on_pattern(self, w):
        """Values of mat(A'w) restricted to pattern P -> (nnzP,)."""
        return jax.ops.segment_sum(
            self.vp * jnp.take(w, self.kp), self.a2p_sorted,
            num_segments=self.pat.nnz, indices_are_sorted=True)

    def es_vals(self, w, sigma):
        """Values on P of eS = mat(c + sigma * A'w)."""
        return self.pat.v + sigma * self.adjoint_on_pattern(w)

    def s_vals(self, y):
        """Values on P of mat(c - A'y) (the dual slack matrix)."""
        return self.pat.v - self.adjoint_on_pattern(y)

    def pattern_dense(self, vals):
        out = jnp.zeros((self.n, self.n), dtype=vals.dtype)
        return out.at[self.pat.i, self.pat.j].add(vals)

    def to_dense_op(self) -> "DenseConstraintOp":
        return DenseConstraintOp.from_op(self)

    # -- operator protocol -------------------------------------------------
    # The AL/ADMM problem builders (solvers/primal_al.py, dual_al.py) see
    # the constraint operator ONLY through the methods below plus
    # apply_from_e / apply_factored / adjoint_on_pattern / es_vals /
    # s_vals, so a mesh-sharded implementation
    # (parallel/sharded_ops.ShardedConstraintOp) can drop in: its
    # pattern-entry arrays are device-sharded and these reductions carry
    # a psum over the mesh axis.
    #
    # Residual-space protocol: multipliers / constraint residuals live in
    # R^m here, but EntrywiseConstraintOp carries them as dense (n, n)
    # representatives — the solvers touch them only through these.
    def res_zeros(self):
        return jnp.zeros(self.m)

    def res_from_mvec(self, y):
        """Host (m,) multipliers -> device residual-space repr."""
        return jnp.asarray(np.asarray(y, dtype=np.float64).ravel())

    def res_to_mvec(self, y_dev):
        """Device residual-space repr -> host (m,) multipliers."""
        return np.asarray(jax.device_get(y_dev))

    def dot_res(self, u, v):
        """<u, v> in residual (constraint) space."""
        return jnp.dot(u, v)

    def norm_res(self, u):
        return jnp.linalg.norm(u)

    @property
    def c_pattern(self):
        """Values of the cost vector c restricted to the pattern P."""
        return self.pat.v

    def dot_pattern(self, u, v):
        """<u, v> over pattern entries (sharded impl: local dot + psum)."""
        return jnp.dot(u, v)

    def colsum_pattern(self, vals):
        """Column sums of mat(vals) on P -> (n,)."""
        return jax.ops.segment_sum(vals, self.pat.j, num_segments=self.n,
                                   indices_are_sorted=True)

    def matmat_pattern(self, Y, vals):
        """Y @ mat(vals) for vals on P -> (p, n)."""
        return self.pat.matmat_vals(Y, vals)

    def matvec_pattern(self, V, vals):
        """mat(vals) @ V for a dense (n, k) block (certificate matvec)."""
        return self.pat.matvec_block(V, vals)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DenseConstraintOp:
    """Constraint operator with DENSE (n, n) pattern carriers — the
    matmul path for moderate n.

    The factored ConstraintOp moves O(nnzP * p) bytes of f64 GATHER
    traffic per Hessian-vector product; once the union pattern is dense
    relative to n (e.g. matrix completion: nnzP ~ 2.6M at n = 4000),
    holding the pattern carriers (e_P, eS, A'w) as dense n x n arrays
    turns the hot products into matmuls (Y'U, Y @ eS) plus one scalar
    gather/scatter of the A entries.  The crossover (config
    dense_al_max_n) is not measured on H100.

    Implements the same operator protocol as ConstraintOp (the AL
    problem builders are polymorphic over it); "pattern values" are
    dense (n, n) arrays here.  Off-pattern garbage cannot leak: every
    value array (C, adjoint scatters) is supported on P only, so dense
    products against them vanish off-pattern exactly.
    """
    k: jax.Array         # (nnzA,) int32 constraint row, sorted
    i: jax.Array
    j: jax.Array
    v: jax.Array
    C: jax.Array         # (n, n) dense cost (symmetric part)
    b: jax.Array
    m: int = dataclasses.field(metadata=dict(static=True))
    n: int = dataclasses.field(metadata=dict(static=True))

    @staticmethod
    def from_op(op: ConstraintOp) -> "DenseConstraintOp":
        return DenseConstraintOp(
            k=op.k, i=op.i, j=op.j, v=op.v,
            C=op.pattern_dense(op.pat.v),
            b=op.b, m=op.m, n=op.n)

    @property
    def nnz(self) -> int:
        return self.v.shape[0]

    # -- operator protocol (dense carriers) --------------------------------
    @property
    def c_pattern(self):
        return self.C

    def pattern_pair_dots(self, Y, U=None):
        """Dense Gram G = Y'U stands in for the pattern dots."""
        return Y.T @ (Y if U is None else U)

    def dot_pattern(self, u, v):
        return jnp.sum(u * v)

    def apply_from_e(self, e):
        vals = self.v * e[self.i, self.j]
        return jax.ops.segment_sum(vals, self.k, num_segments=self.m,
                                   indices_are_sorted=True)

    def apply_factored(self, Y, U=None):
        return self.apply_from_e(self.pattern_pair_dots(Y, U))

    def adjoint_on_pattern(self, w):
        out = jnp.zeros((self.n, self.n), dtype=w.dtype)
        return out.at[self.i, self.j].add(self.v * jnp.take(w, self.k))

    def es_vals(self, w, sigma):
        return self.C.astype(w.dtype) + sigma * self.adjoint_on_pattern(w)

    def s_vals(self, y):
        return self.C.astype(y.dtype) - self.adjoint_on_pattern(y)

    def colsum_pattern(self, vals):
        return jnp.sum(vals, axis=0)

    def matmat_pattern(self, Y, vals):
        return Y @ vals

    def matvec_pattern(self, V, vals):
        return vals @ V

    # residual-space protocol (same (m,) layout as ConstraintOp)
    def res_zeros(self):
        return jnp.zeros(self.m)

    def res_from_mvec(self, y):
        return jnp.asarray(np.asarray(y, dtype=np.float64).ravel())

    def res_to_mvec(self, y_dev):
        return np.asarray(jax.device_get(y_dev))

    def dot_res(self, u, v):
        return jnp.dot(u, v)

    def norm_res(self, u):
        return jnp.linalg.norm(u)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class EntrywiseConstraintOp:
    """Constraint operator for ENTRYWISE-sample constraint sets — the
    matrix-completion class.

    Every constraint touches a single matrix entry: either one diagonal
    position {(i,i)} or a symmetric off-diagonal pair {(i,j), (j,i)}
    with equal coefficients (e.g. X[j, p+k] + X[p+k, j] = b
    in example_matrixcompletion.m:50-60; reference solver hot path
    src/primal/ManiSDP.m:161-165).  Then A'A is DIAGONAL and the whole
    AL algebra collapses to dense masked elementwise ops + matmuls:

      A(M)   (dense rep) = dfac .* (aval.*M + (aval.*M)')
      mat(A'w)           = aval .* W            (W = dense rep of w)
      mat(A'A vec(V))    = dfac .* aval^2 .* (V + V')

    NO gather / scatter anywhere on the hot path — the generic
    operators need m-length gathers (ConstraintOp) or n^2 scatters
    (DenseConstraintOp); here a Hessian-vector product is three
    (n, n) x (n, p) matmuls plus elementwise work.

    Residual space: multipliers y and residuals A(X)-b are carried as
    dense (n, n) symmetric representatives D with D[i,j] = w_k for each
    position of constraint k.  Inner products weight positions by
    1/mult (``minv``) so they equal the R^m inner products exactly.
    """
    aval: jax.Array      # (n, n) constraint coefficient at each position
    C: jax.Array         # (n, n) dense symmetric cost
    b: jax.Array         # (n, n) dense rep of the right-hand side
    minv: jax.Array      # (n, n) 1/mult on the sample mask, 0 elsewhere
    dfac: jax.Array      # (n, n) 0.5/minv on the mask (1 off-diag, 0.5 diag)
    # host-side constraint indexing for (m,) <-> dense conversions;
    # unused inside jitted code (int leaves, ignored by dtype casts)
    ki: jax.Array        # (m,) int32 row of constraint k's entry
    kj: jax.Array        # (m,) int32 col (ki <= kj canonical)
    m: int = dataclasses.field(metadata=dict(static=True))
    n: int = dataclasses.field(metadata=dict(static=True))

    # -- construction ------------------------------------------------------
    @staticmethod
    def detect(op: ConstraintOp) -> Optional["EntrywiseConstraintOp"]:
        """Build from a generic ConstraintOp iff every constraint is
        entrywise (single diagonal entry, or a symmetric off-diagonal
        pair with equal values).  Returns None otherwise."""
        k = np.asarray(op.k)
        i = np.asarray(op.i)
        j = np.asarray(op.j)
        v = np.asarray(op.v)
        m, n = op.m, op.n
        counts = np.bincount(k, minlength=m)
        if counts.size == 0 or counts.max() > 2 or counts.min() < 1:
            return None
        # canonical per-entry key; a 2-entry constraint must be the
        # symmetric pair (i,j),(j,i) with equal values
        order = np.argsort(k, kind="stable")   # already sorted, but safe
        k, i, j, v = k[order], i[order], j[order], v[order]
        first = np.concatenate([[0], np.cumsum(counts)[:-1]])
        two = counts == 2
        if np.any(two):
            a = first[two]
            if not (np.array_equal(i[a], j[a + 1])
                    and np.array_equal(j[a], i[a + 1])
                    and np.allclose(v[a], v[a + 1])
                    and np.all(i[a] != j[a])):
                return None
        one = counts == 1
        if np.any(one) and np.any(i[first[one]] != j[first[one]]):
            return None            # lone off-diagonal entry: asymmetric A_k

        # no two constraints may share a position (aval would collide)
        keys = i.astype(np.int64) * n + j
        if np.unique(keys).shape[0] != keys.shape[0]:
            return None

        b_host = np.asarray(op.b)
        aval = np.zeros((n, n))
        brep = np.zeros((n, n))
        mult = np.zeros((n, n))
        aval[i, j] = v
        ii = i[first]
        jj = j[first]
        brep[i, j] = b_host[k]
        mult[i, j] = 1.0                 # support marker (entries unique)
        # a constraint occupies 2 positions off-diagonal, 1 on it
        offd = (np.arange(n)[:, None] != np.arange(n)[None, :])
        mult = mult * np.where(offd, 2.0, 1.0)
        minv = np.where(mult > 0, 1.0 / np.maximum(mult, 1.0), 0.0)
        dfac = np.where(mult > 0, 0.5 * mult, 0.0)
        C = np.zeros((n, n))
        C[np.asarray(op.pat.i), np.asarray(op.pat.j)] = np.asarray(op.pat.v)
        lo = np.minimum(ii, jj).astype(np.int32)
        hi = np.maximum(ii, jj).astype(np.int32)
        return EntrywiseConstraintOp(
            aval=jnp.asarray(aval), C=jnp.asarray(C), b=jnp.asarray(brep),
            minv=jnp.asarray(minv), dfac=jnp.asarray(dfac),
            ki=jnp.asarray(lo), kj=jnp.asarray(hi), m=int(m), n=int(n))

    @property
    def nnz(self) -> int:
        return self.m

    # -- operator protocol (dense masked carriers) -------------------------
    @property
    def c_pattern(self):
        return self.C

    def pattern_pair_dots(self, Y, U=None):
        return Y.T @ (Y if U is None else U)

    def dot_pattern(self, u, v):
        return jnp.sum(u * v)

    def apply_from_e(self, e):
        R = self.aval.astype(e.dtype) * e
        return self.dfac.astype(e.dtype) * (R + R.T)

    def apply_factored(self, Y, U=None):
        return self.apply_from_e(self.pattern_pair_dots(Y, U))

    def adjoint_on_pattern(self, w):
        return self.aval.astype(w.dtype) * w

    def es_vals(self, w, sigma):
        return self.C.astype(w.dtype) + sigma * self.adjoint_on_pattern(w)

    def s_vals(self, y):
        return self.C.astype(y.dtype) - self.adjoint_on_pattern(y)

    def colsum_pattern(self, vals):
        return jnp.sum(vals, axis=0)

    def matmat_pattern(self, Y, vals):
        return Y @ vals

    def matvec_pattern(self, V, vals):
        return vals @ V

    # -- residual space (dense (n, n) representatives) ---------------------
    def res_zeros(self):
        return jnp.zeros((self.n, self.n))

    def res_from_mvec(self, y):
        y = np.asarray(y, dtype=np.float64).ravel()
        ki = np.asarray(self.ki)
        kj = np.asarray(self.kj)
        out = np.zeros((self.n, self.n))
        out[ki, kj] = y
        out[kj, ki] = y
        return jnp.asarray(out)

    def res_to_mvec(self, y_dev):
        D = np.asarray(jax.device_get(y_dev))
        return D[np.asarray(self.ki), np.asarray(self.kj)]

    def dot_res(self, u, v):
        return jnp.sum(u * v * self.minv.astype(u.dtype))

    def norm_res(self, u):
        return jnp.sqrt(self.dot_res(u, u))
