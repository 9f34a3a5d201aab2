"""Gather-free BQP moment-SDP constraint operator (primal analogue of
ops/symdual.SymDualOp).

The order-2 moment relaxation of  min x'Qx + e'x over {-1,1}^q
(reference src/basicfunction/bqpmom.m, rebuilt in frontends/moments.py)
feeds the primal unit-diagonal AL driver (src/primal/ManiSDP_unitdiag.m)
with a sparse constraint matrix of m ~ mb^2/2 rows over the moment
basis [1, x_a, x_{ab}] (mb = 1 + q + C(q,2)).  The sparse pipeline's
A(X)/A'(y) are one scalar gather per nonzero — this module removes the
gathers entirely by working on the same EXPANDED pair basis as
SymDualOp:

    [ 1, 1', x_a (a < q), q x q grid slot(i, j) = x_i x_j (i != j),
      slot(a, a) = x_a' ]                      (n~ = 2 + q + q^2)

Each original basis column has exactly TWO copies.  Unlike the SOS dual
(where constraint rows are CLASS SUMS and inflate 4x), the bqpmom rows
are built from individual (symmetrized) matrix ENTRIES with explicit
weights — so here ``apply`` reads the COPY-AVERAGE of each original
entry (equal to the original value on the duplicate-symmetric subspace)
and reproduces A(X_orig) EXACTLY, row for row; ``adjoint`` is the exact
linear adjoint (each read slot receives weight/4).  Consequently
pinf / obj / gap equal the reference's verbatim, and the only parameter
remapping the expanded driver needs is geometric: gradients halve per
column, so

    tau1/tau2 -> sqrt(2) * tau,  tolgradnorm -> tolgradnorm / sqrt(2),

with sigma and all residual quantities UNCHANGED (contrast
solve_bqp_sos_dual's sigma/4; see solvers/primal_mom.py for the
derivation).  Escape directions lift like SymDualOp's (each copy
v/sqrt(2), then scaled sqrt(2) by the driver).

Row families of bqpmom.m (0-based variables; "sym(u,v)" is the
symmetrized entry 0.5(X_uv + X_vu); colex pair order as
frontends/monomials.py):

  r0   : X_00 = 1                                        (bqpmom.m:36)
  D1   : 0.5 X_00 - 0.5 X_aa                  (q rows,  bqpmom.m:39-43)
  D2   : 0.5 X_aa - 0.5 X_{ab,ab}    (2 per pair col,   bqpmom.m:45-52)
  SUBv : 2 sym(x_k, x_kb) - 2 sym(1, x_b)       (substitution x_k^2=1
  SUBp : 2 sym(x_kb, x_kc)                       at degree-1/2 labels,
          - sym(1, x_bc) - sym(x_b, x_c)         bqpmom.m:60-78)
  EQ2  : sym(x_a, x_b) - sym(1, x_ab)           (repeated-monomial
  EQ4  : sym(x_c, x_ab) - sym(x_a, x_bc)         equality rows,
         sym(x_c, x_ab) - sym(x_b, x_ac)         bqpmom.m:80-90; the
  EQ6  : sym(x_bc, x_ad) - sym(x_ab, x_cd)       rep is the pair with
         sym(x_bc, x_ad) - sym(x_ac, x_bd)       largest first column)

Flat multiplier ("m-space") layout — dense per-index tensors with
don't-care slots EXACTLY ZERO in apply() and b:

  [ r0 (1,), D1 (q,), D2 (q,q | a != b), SUBv (q,q | k != b),
    SUBp (q,q,q | b < c, k not in {b,c}), EQ2 (q,q | a < b),
    EQ4 (q,q,q | i != j, k > max(i,j)),
    EQ6 (q,q,q,q | i<j<k<l row 1, i<j<l<k row 2) ]

Row-for-row exactness against frontends/moments.bqpmom is tested in
tests/test_symmom.py (explicit slot map), along with <A'y, M> ==
<y, A(M)> adjointness.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from math import comb

import jax
import jax.numpy as jnp
import numpy as np

from .symdual import _symmetrize_jit


def _iotas(q, dim):
    return [jax.lax.broadcasted_iota(jnp.int32, (q,) * dim, a)
            for a in range(dim)]


# ---------------------------------------------------------------------------
# compression: expanded SYMMETRIC (n~, n~) matrix -> original-entry tensors
# ---------------------------------------------------------------------------

def _compress_entries(M, q):
    """Copy-averaged original-entry tensors of a SYMMETRIC M.

      c00          scalar   X(1, 1)
      cA  (q,)              sym(1, x_a)
      cD  (q,)              X(x_a, x_a)
      cG  (q,q)             sym(x_a, x_b)         a != b
      cP0 (q,q)             sym(1, x_ab)          a != b (symmetric)
      cH  (q,q,q)           sym(x_a, x_bc)        b != c (sym in b,c;
                                                  a may equal b or c)
      cT  (q,q,q,q)         sym(x_ab, x_cd)       a != b, c != d
    Slots violating the index conditions are unspecified.
    """
    o = 2 + q
    s = M[:2, :2]
    u = M[:2, 2:o]                          # const copies x first copies
    E = M[:2, o:].reshape(2, q, q)          # const copies x grid
    G = M[2:o, 2:o]                         # first x first
    H = M[2:o, o:].reshape(q, q, q)         # H[a, i, j] = x_a x grid(i,j)
    T = M[o:, o:].reshape(q, q, q, q)

    c00 = 0.25 * (s[0, 0] + s[0, 1] + s[1, 0] + s[1, 1])
    dE = jnp.einsum('sii->si', E)
    cA = 0.25 * (u[0] + u[1] + dE[0] + dE[1])
    cD = 0.25 * (jnp.diagonal(G) + 2.0 * jnp.einsum('aaa->a', H)
                 + jnp.einsum('aaaa->a', T))
    cG = 0.25 * (G + jnp.einsum('abb->ab', H) + jnp.einsum('baa->ab', H)
                 + jnp.einsum('aabb->ab', T))
    cP0 = 0.25 * (E[0] + E[0].T + E[1] + E[1].T)
    Td = jnp.einsum('aabc->abc', T)
    cH = 0.25 * (H + jnp.swapaxes(H, 1, 2) + Td + jnp.swapaxes(Td, 1, 2))
    # ONE minor-axis-moving transpose (swap23), then the cheap swap01
    P = T + jnp.swapaxes(T, 2, 3)
    cT = 0.25 * (P + jnp.swapaxes(P, 0, 1))
    return c00, cA, cD, cG, cP0, cH, cT


def _spread_entries(q, w00, wA, wD, wG, wP0, wH, wT, dtype):
    """EXACT adjoint of _compress_entries.

    Coefficient tensors (already MASKED: wG off-diagonal, wH last-two
    distinct, wT with i!=j and k!=l) -> dense (n~, n~).  Only the
    blocks _compress_entries READS (s, u, E, G, H, T) are filled, then
    the whole matrix is symmetrized — the adjoint of the driver-side
    input symmetrization Sym(M) = (M + M')/2."""
    o = 2 + q
    nn = o + q * q
    eye = jnp.eye(q, dtype=dtype)
    M = jnp.zeros((nn, nn), dtype=dtype)

    # c00 -> all four constant-block slots
    M = M.at[:2, :2].add(0.25 * w00)
    # cA -> u[0], u[1] and the E diagonals E[s, a, a]
    M = M.at[0, 2:o].add(0.25 * wA)
    M = M.at[1, 2:o].add(0.25 * wA)
    Eacc = 0.25 * wA[:, None] * eye + 0.25 * (wP0 + wP0.T)
    M = M.at[0, o:].add(Eacc.reshape(-1))
    M = M.at[1, o:].add(Eacc.reshape(-1))

    # G block: cD diagonal + cG off-diagonal
    M = M.at[2:o, 2:o].add(0.25 * (jnp.diag(wD) + wG))

    # H block: cD -> 2 * H[a,a,a]; cG -> H[a,b,b] and H[b,a,a];
    # cH -> H[a,b,c] + H[a,c,b]
    wHs = 0.25 * (wH + jnp.swapaxes(wH, 1, 2))
    Hacc = (0.5 * wD[:, None, None] * (eye[:, :, None] * eye[:, None, :])
            + 0.25 * wG[:, :, None] * eye[None, :, :]       # (a, b, b)
            + 0.25 * wG.T[:, :, None] * eye[None, :, :]     # (b, a, a)
            + wHs)
    M = M.at[2:o, o:].add(Hacc.reshape(q, -1))

    # T block: cD -> T[a,a,a,a]; cG -> T[a,a,b,b]; cH -> T[a,a,b,c]
    # (+ swap); cT -> all four order-swaps
    wTs = 0.25 * (wT + jnp.swapaxes(wT, 2, 3))
    wTs = wTs + jnp.swapaxes(wTs, 0, 1)     # combined with axes (2,3) sym
    d2 = eye[:, :, None, None] * eye[None, None, :, :]   # d(ij) d(kl)
    # T[a,a,a,a] += 0.25 wD[a]  (broadcast, NOT a wD[i4] gather over
    # the whole q^4 tensor)
    i4, j4, k4, l4 = _iotas(q, 4)
    Tacc = jnp.where((i4 == j4) & (j4 == k4) & (k4 == l4),
                     0.25 * wD[:, None, None, None], 0.0).astype(dtype)
    # T[a,a,b,b] += 0.25 wG[a,b] (a != b; wG masked)
    Tacc = Tacc + 0.25 * wG[:, None, :, None] * d2
    # T[a,a,b,c] + T[a,a,c,b] += wHs[a,b,c] (b != c; masked)
    Tacc = Tacc + eye[:, :, None, None] * wHs[:, None, :, :]
    Tacc = Tacc + wTs
    M = M.at[o:, o:].add(Tacc.reshape(q * q, q * q))
    return 0.5 * (M + M.T)


# ---------------------------------------------------------------------------
# row assembly and its adjoint
# ---------------------------------------------------------------------------

def _masks(q):
    i2, j2 = _iotas(q, 2)
    off2 = i2 != j2
    lt2 = i2 < j2
    i3, j3, k3 = _iotas(q, 3)
    m_subp = (j3 < k3) & (i3 != j3) & (i3 != k3)
    m_eq4 = (i3 != j3) & (k3 > i3) & (k3 > j3)
    i4, j4, k4, l4 = _iotas(q, 4)
    m_eq6a = (i4 < j4) & (j4 < k4) & (k4 < l4)
    # row 2 of each {a<b<c<d} class lives at slot [b, a, c, d]: with
    # this convention EVERY q^4 permute in the EQ6 read/adjoint keeps
    # the LAST axis fixed (a transpose that moves the minor-most
    # dimension is a full strided copy of the q^4 tensor)
    m_eq6b = (j4 < i4) & (i4 < k4) & (k4 < l4)
    return off2, lt2, m_subp, m_eq4, m_eq6a, m_eq6b


def _rows_from_entries(q, c00, cA, cD, cG, cP0, cH, cT):
    dt = cT.dtype
    off2, lt2, m_subp, m_eq4, m_eq6a, m_eq6b = _masks(q)
    z2 = jnp.zeros((q, q), dtype=dt)
    z3 = jnp.zeros((q, q, q), dtype=dt)
    z4 = jnp.zeros((q, q, q, q), dtype=dt)

    r0 = c00
    D1 = 0.5 * c00 - 0.5 * cD
    cPD = jnp.einsum('abab->ab', cT)
    D2 = jnp.where(off2, 0.5 * cD[:, None] - 0.5 * cPD, z2)
    cHkk = jnp.einsum('kkb->kb', cH)
    SUBv = jnp.where(off2, 2.0 * cHkk - 2.0 * cA[None, :], z2)
    cTkk = jnp.einsum('kbkc->kbc', cT)
    SUBp = jnp.where(m_subp,
                     2.0 * cTkk - (cP0 + cG)[None, :, :], z3)
    EQ2 = jnp.where(lt2, cG - cP0, z2)
    tH = jnp.einsum('kij->ijk', cH)
    EQ4 = jnp.where(m_eq4, tH - cH, z3)
    # row 1 at [a,b,c,d]: cT[b,c,a,d] - cT[a,b,c,d]  (read W1 - cT);
    # row 2 at [b,a,c,d]: cT[b,c,a,d] - cT[a,c,b,d]  (read U - W1 at
    # the permuted slot).  Both W1 and U keep the last axis in place.
    W1 = jnp.einsum('jkil->ijkl', cT)
    U6 = jnp.einsum('ikjl->ijkl', cT)
    EQ6 = jnp.where(m_eq6a, W1 - cT, z4) + jnp.where(m_eq6b, U6 - W1, z4)
    return jnp.concatenate([
        r0[None], D1, D2.reshape(-1), SUBv.reshape(-1), SUBp.reshape(-1),
        EQ2.reshape(-1), EQ4.reshape(-1), EQ6.reshape(-1)])


def _split_rows(y, q):
    q2, q3 = q * q, q ** 3
    offs = np.cumsum([1, q, q2, q2, q3, q2, q3])
    y0 = y[0]
    yD1 = y[1:1 + q]
    yD2 = y[offs[1]:offs[2]].reshape(q, q)
    ySv = y[offs[2]:offs[3]].reshape(q, q)
    ySp = y[offs[3]:offs[4]].reshape(q, q, q)
    yE2 = y[offs[4]:offs[5]].reshape(q, q)
    yE4 = y[offs[5]:offs[6]].reshape(q, q, q)
    yE6 = y[offs[6]:].reshape(q, q, q, q)
    return y0, yD1, yD2, ySv, ySp, yE2, yE4, yE6


def _entries_from_rows(q, y, dtype):
    """Adjoint of _rows_from_entries: flat multipliers -> masked
    coefficient tensors on the original entries."""
    off2, lt2, m_subp, m_eq4, m_eq6a, m_eq6b = _masks(q)
    y0, yD1, yD2, ySv, ySp, yE2, yE4, yE6 = _split_rows(y, q)
    z2 = jnp.zeros((q, q), dtype=dtype)
    z3 = jnp.zeros((q, q, q), dtype=dtype)
    z4 = jnp.zeros((q, q, q, q), dtype=dtype)
    yD2 = jnp.where(off2, yD2, z2)
    ySv = jnp.where(off2, ySv, z2)
    ySp = jnp.where(m_subp, ySp, z3)
    yE2 = jnp.where(lt2, yE2, z2)
    yE4 = jnp.where(m_eq4, yE4, z3)
    y6a = jnp.where(m_eq6a, yE6, z4)
    y6b = jnp.where(m_eq6b, yE6, z4)
    eye = jnp.eye(q, dtype=dtype)

    w00 = y0 + 0.5 * jnp.sum(yD1)
    wD = -0.5 * yD1 + 0.5 * jnp.sum(yD2, axis=1)
    wA = -2.0 * jnp.sum(ySv, axis=0)
    wG = yE2 - jnp.sum(ySp, axis=0)
    wP0 = -yE2 - jnp.sum(ySp, axis=0)
    # wH: SUBv -> cH[k,k,b] (+2); EQ4 -> +cH[k,i,j] - cH[i,j,k]
    wH = (2.0 * ySv[:, None, :] * eye[:, :, None]
          + jnp.einsum('ijk->kij', yE4) - yE4)
    # wT: D2 -> -0.5 cT[a,b,a,b]; SUBp -> +2 cT[k,b,k,c];
    # EQ6 row 1 reads +cT[j,k,i,l] - cT[i,j,k,l]; row 2 (slot
    # [b,a,c,d]) reads +cT[i,k,j,l] - cT[j,k,i,l] — adjoints are the
    # last-axis-preserving permutes 'cabd'/'acbd'
    dik = eye[:, None, :, None]
    djl = eye[None, :, None, :]
    wT = (-0.5 * yD2[:, :, None, None] * dik * djl
          + 2.0 * ySp[:, :, None, :] * dik
          + jnp.einsum('cabd->abcd', y6a - y6b) - y6a
          + jnp.einsum('acbd->abcd', y6b))
    # mask to the read conventions of _spread_entries
    i2, j2 = _iotas(q, 2)
    wG = jnp.where(off2, wG, z2)
    wP0 = jnp.where(off2, wP0, z2)
    i3, j3, k3 = _iotas(q, 3)
    wH = jnp.where(j3 != k3, wH, z3)
    i4, j4, k4, l4 = _iotas(q, 4)
    wT = jnp.where((i4 != j4) & (k4 != l4), wT, z4)
    return w00, wA, wD, wG, wP0, wH, wT


# ---------------------------------------------------------------------------
# jitted operator kernels
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnums=(1,))
def _apply_jit(M, q: int):
    Ms = 0.5 * (M + M.T)
    return _rows_from_entries(q, *_compress_entries(Ms, q))


@partial(jax.jit, static_argnums=(1,))
def _adjoint_jit(y, q: int):
    dt = y.dtype
    return _spread_entries(q, *_entries_from_rows(q, y, dt), dt)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SymMomOp:
    """Dense-tensor drop-in for ConstraintOp on the bqpmom relaxation.

    Implements the primal AL operator protocol with DENSE (n~, n~)
    pattern carriers (same protocol as ops/sparse.DenseConstraintOp):
    pattern values ARE the dense matrix; residual space is the flat
    per-family tensor layout above.  ``n`` is the EXPANDED basis size
    n~ = 2 + q + q^2; ``n_orig`` = 1 + q + C(q, 2) = the reference's
    mb; ``m`` the flat residual length; ``m_true`` the reference's
    constraint count (for logging / p0)."""
    C: jax.Array                # (n~, n~) dense expanded cost
    dup0: jax.Array             # (n_orig,) first copy column of each
    dup1: jax.Array             # (n_orig,) second copy column
    q: int = dataclasses.field(metadata=dict(static=True))
    m: int = dataclasses.field(metadata=dict(static=True))
    n: int = dataclasses.field(metadata=dict(static=True))
    m_true: int = dataclasses.field(metadata=dict(static=True))
    n_orig: int = dataclasses.field(metadata=dict(static=True))

    # -- operator protocol (dense carriers) -------------------------------
    @property
    def c_pattern(self):
        return self.C

    @property
    def b(self):
        return jnp.zeros(self.m, dtype=jnp.float64).at[0].set(1.0)

    def pattern_pair_dots(self, Y, U=None):
        return Y.T @ (Y if U is None else U)

    def dot_pattern(self, u, v):
        return jnp.sum(u * v)

    def colsum_pattern(self, vals):
        return jnp.sum(vals, axis=0)

    def matmat_pattern(self, Y, vals):
        return Y @ vals

    def matvec_pattern(self, V, vals):
        return vals @ V

    def apply_from_e(self, e):
        return _apply_jit(e, self.q)

    def apply_factored(self, Y, U=None):
        return self.apply_from_e(self.pattern_pair_dots(Y, U))

    def adjoint_on_pattern(self, w):
        return _adjoint_jit(w, self.q)

    def es_vals(self, Axb, sigma):
        """C + sigma * A'(Axb) as a dense matrix (gradient carrier)."""
        return self.C + sigma * self.adjoint_on_pattern(Axb)

    def s_vals(self, y):
        """C - A'(y) (dual slack carrier)."""
        return self.C - self.adjoint_on_pattern(y)

    # -- residual space ----------------------------------------------------
    def res_zeros(self):
        return jnp.zeros(self.m, dtype=jnp.float64)

    def res_from_mvec(self, y):
        return jnp.asarray(np.asarray(y, dtype=np.float64).ravel())

    def res_to_mvec(self, y_dev):
        return np.asarray(jax.device_get(y_dev))

    def dot_res(self, u, v):
        return jnp.dot(u, v)

    def norm_res(self, u):
        return jnp.linalg.norm(u)

    # -- expanded-basis hooks (as SymDualOp) -------------------------------
    def symmetrize(self, Y, renorm: bool = True):
        return _symmetrize_jit(jnp.asarray(Y), self.q, bool(renorm))

    def compress(self, M_dev):
        """Original-basis (n_orig, n_orig) VALUE matrix: read the
        representative slots (copy values are equal on the symmetric
        subspace; no 4x — values, not coefficients)."""
        return M_dev[self.dup0][:, self.dup0]

    def compress_coef(self, M_dev):
        """Original-basis COEFFICIENT matrix of a spread operator
        matrix (e.g. s_vals output): 4x the copy-average."""
        return 4.0 * M_dev[self.dup0][:, self.dup0]

    def lift_vecs(self, V: np.ndarray) -> np.ndarray:
        out = np.zeros((self.n, V.shape[1]), dtype=V.dtype)
        s = np.asarray(V) / np.sqrt(2.0)
        out[np.asarray(self.dup0)] = s
        out[np.asarray(self.dup1)] = s
        return out

    # -- builder -----------------------------------------------------------
    @staticmethod
    def build_bqpmom(Q, e, q: int) -> "SymMomOp":
        """Expanded operator for the bqpmom relaxation of
        min x'Qx + e'x over {-1,1}^q (frontends/moments.bqpmom
        semantics; row-for-row tested in tests/test_symmom.py)."""
        Q = np.asarray(Q, dtype=np.float64)
        e = np.asarray(e, dtype=np.float64).ravel()
        o = 2 + q
        nn = o + q * q

        def grid(i, j):
            return o + i * q + j

        # expanded cost: spread of the reference C (bqpmom.m:93-114):
        # W[(x_i, x_i)] = Q_ii;  W[(1, x_i)] = W[(x_i, 1)] = e_i / 2;
        # W[(1, x_ij)] = W[(x_i, x_j)] = Q_ij / 2 (+ transposes);
        # every ordered copy pair receives W/4.
        Cx = np.zeros((nn, nn))
        const = (0, 1)
        for i in range(q):
            ci = (2 + i, grid(i, i))
            for a in ci:
                for bcol in ci:
                    Cx[a, bcol] += Q[i, i] / 4.0
            for a in const:
                for bcol in ci:
                    Cx[a, bcol] += e[i] / 8.0
                    Cx[bcol, a] += e[i] / 8.0
        for i in range(q):
            for j in range(i + 1, q):
                cij = (grid(i, j), grid(j, i))
                for a in const:
                    for bcol in cij:
                        Cx[a, bcol] += Q[i, j] / 8.0
                        Cx[bcol, a] += Q[i, j] / 8.0
                ci = (2 + i, grid(i, i))
                cj = (2 + j, grid(j, j))
                for a in ci:
                    for bcol in cj:
                        Cx[a, bcol] += Q[i, j] / 8.0
                        Cx[bcol, a] += Q[i, j] / 8.0

        iu, ju = np.triu_indices(q, k=1)
        order = np.lexsort((iu, ju))        # colex: (v major, u minor)
        pa, pb = iu[order], ju[order]
        rep = np.concatenate([[0], 2 + np.arange(q), grid(pa, pb)])
        dup = np.concatenate([[1], grid(np.arange(q), np.arange(q)),
                              grid(pb, pa)])
        mb = 1 + q + comb(q, 2)
        lsp = (q + comb(q, 2) + q * (q - 1)        # {a},{ab},{k2 b}
               + comb(q, 3) + q * comb(q - 1, 2) + comb(q, 4))
        m_true = mb * (mb + 1) // 2 - lsp + q * (mb - 1) - mb + 1
        m_flat = 1 + q + 3 * q * q + 2 * q ** 3 + q ** 4
        return SymMomOp(
            C=jnp.asarray(Cx), dup0=jnp.asarray(rep, dtype=jnp.int32),
            dup1=jnp.asarray(dup, dtype=jnp.int32),
            q=q, m=m_flat, n=nn, m_true=m_true, n_orig=mb)
