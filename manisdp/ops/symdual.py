"""Gather-free SOS-dual operator on the expanded pair basis.

The sparse constraint pipeline of the SOS-dual (bqpsos-class) solves
is one scalar gather and one segment-sum per nonzero: at q = 60
(n = 1831, m = 523,686, nnz(A) = n^2).  This module removes the
gathers entirely (the chip_smoke ``ops`` phase times both routes on
the same rows).

Structure exploited (reference src/basicfunction/bqpsos.m:17-31, rebuilt
in frontends/sos.py): the BQP SOS constraint matrix is a PARTITION —
each matrix entry (u, v) belongs to exactly one constraint row, the
squarefree monomial class mask(u) XOR mask(v) — with unit weights and
therefore diagonal AA'.  On the EXPANDED basis

    [ 1, 1',  x_a (a < q),  q x q grid: slot(i, j) = x_i x_j (i != j),
      slot(a, a) = x_a'  (second copies) ]

(n~ = 2 + q + q^2 columns; every original basis column appears EXACTLY
twice, so every monomial class receives exactly 4x the original's
entries — uniform inflation, which makes the expanded ADMM trajectory
track the reference's exactly under a (sigma/4, 2*sqrt(2)*tau,
tolgradnorm/sqrt(2)) parameter mapping; see solve_bqp_sos_dual in
solvers/dual_unitdiag.py for the single-source derivation), the class
of every entry is a pure
index-coincidence pattern, so:

  - ``apply``  = dense symmetrizations + partial traces of the (q,q,q,q)
    Q-block tensor (plus small L/constant-block terms) — einsums and
    reductions, ZERO gathers;
  - ``adjoint`` = masked broadcasts of per-degree dense coefficient
    tensors back into the (n~, n~) matrix — ZERO scatters.

The expanded program is itself a valid SOS program over the same
monomial set (duplicate basis entries only enlarge the certificate
class; any original unit-diagonal certificate S lifts to an expanded
one with identical polynomial and objective via S~ = Q'SQ + N with a
polynomial-neutral psd correction N on the duplicate pairs), so the
optimal bound matches the reference formulation on instances where the
order-2 relaxation is tight — verified against the original-basis
solver in tests/test_symdual.py.

m-space layout ("flat"): the per-class multiplier vector is stored as
the concatenation of DENSE per-degree tensors

    [ y0 (1,), y1 (q,), Y2 (q,q), Y3 (q,q,q), Y4 (q,q,q,q) ]

holding the class value at EVERY permutation of distinct indices;
repeated-index entries are don't-care (never read by ``adjoint``, and
the stored ``b`` is zero there).  This keeps the driver's vector
algebra (dot(b, y), idAAt * y) valid unchanged: a degree-2 class
{a,b} occupies the two slots (a,b), (b,a), so b2[a,b] = Q[a,b] makes
dot(b, y) = sum_alpha b_alpha y_alpha exactly.

Drop-in compatible with ops.dualops.DualOp for the dual_unitdiag
driver: same attribute/method surface (apply/adjoint/y_step/B/b/cf/
C/bA/Ac/idAAt/m/n/f).  Reference semantics preserved:
ManiDSDP_unitdiag.m:34-41 (iA, bA precompute), :74 (closed-form
y-step), :174-194 (cost/grad/hess algebra) — the algebra is untouched,
only the operator representation changes.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .dualops import SparseMat


def _blocks(M, q):
    """Split an (n~, n~) matrix into the basis blocks.

    Layout (n~ = 2 + q + q^2): cols 0,1 = the TWO copies of the
    constant; cols 2..2+q = x_a (first copies); the q x q Q-grid with
    slot(i, j) = x_i x_j for i != j and slot(a, a) = the SECOND copy
    of x_a.  Every original column thus has exactly two copies, making
    every class size exactly 4x the original's (see _apply_tensor).
    """
    o = 2 + q
    s = M[:2, :2]
    u = M[:2, 2:o]                          # (2, q)
    uT = M[2:o, :2]                         # (q, 2)
    E = M[:2, o:].reshape(2, q, q)          # E[s, i, j]
    F = M[o:, :2].reshape(q, q, 2)          # F[i, j, s]
    G = M[2:o, 2:o]
    H = M[2:o, o:].reshape(q, q, q)         # H[b, i, j]
    K = M[o:, 2:o].reshape(q, q, q)         # K[i, j, b]
    T = M[o:, o:].reshape(q, q, q, q)       # T[i, j, k, l]
    return s, u, uT, E, F, G, H, K, T


def _apply_tensor(M, q):
    """Per-degree class sums of an (n~, n~) matrix.

    Returns (y0 scalar, y1 (q,), Y2 (q,q), Y3 (q,q,q), Y4 (q,q,q,q));
    entries of Y2/Y3/Y4 at repeated indices are unspecified.

    Every ordered pair of expanded columns falls in exactly one
    index-coincidence pattern; the patterns partition into the einsum
    terms below.  Because each original column has exactly two copies,
    every class receives exactly 4x the original basis's entries —
    the uniform inflation that makes the expanded ADMM trajectory
    track the reference's exactly under (sigma -> sigma/4,
    tau -> 2*sqrt(2)*tau, tolgradnorm -> tolgradnorm/sqrt(2)); see
    solve_bqp_sos_dual for the mapping derivation.
    """
    s, u, uT, E, F, G, H, K, T = _blocks(M, q)
    dt = M.dtype
    moff = 1.0 - jnp.eye(q, dtype=dt)
    Tn = T * moff[:, :, None, None] * moff[None, None, :, :]
    Hn = H * moff[None, :, :]
    Kn = K * moff[:, :, None]

    # -- degree 0 (constant class): pairs of copies of one column --
    y0 = (jnp.sum(s) + jnp.trace(G)
          + jnp.einsum('aaa->', H) + jnp.einsum('aaa->', K)
          + jnp.einsum('iiii->', T)
          + jnp.einsum('ijij->', Tn) + jnp.einsum('ijji->', Tn))

    # -- degree 1: classes {a} --
    # (const, x_a) across all copies, then (x_c, x_c x_a) patterns:
    # L x Q ('iia', 'jaj'), Q x L ('iai', 'ajj'), and the Q-diag-slot
    # copies: three-equal-index planes of T (the c = a overlap is the
    # all-equal diagonal, subtracted once per plane).
    y1 = (jnp.sum(u, axis=0) + jnp.sum(uT, axis=1)
          + jnp.einsum('sii->i', E) + jnp.einsum('iis->i', F)
          + jnp.einsum('iia->a', Hn) + jnp.einsum('jaj->a', Hn)
          + jnp.einsum('iai->a', Kn) + jnp.einsum('ajj->a', Kn)
          + jnp.einsum('ccca->a', T) + jnp.einsum('ccac->a', T)
          + jnp.einsum('cacc->a', T) + jnp.einsum('accc->a', T)
          - 4.0 * jnp.einsum('aaaa->a', T))

    # -- degree 2: classes {a,b} (dense; diagonal don't-care) --
    # A4 counts the shared-index off-diagonal Q x Q pairs whose
    # a-containing slot comes first; the b-first orderings are its
    # transpose.  HD/KD/DD are the second-copy (Q-diagonal) patterns.
    A4 = (jnp.einsum('acbc->ab', Tn) + jnp.einsum('accb->ab', Tn)
          + jnp.einsum('cabc->ab', Tn) + jnp.einsum('cacb->ab', Tn))
    Es = jnp.sum(E, axis=0)
    Fs = jnp.sum(F, axis=2)
    HD = jnp.einsum('abb->ab', H)
    KD = jnp.einsum('ccb->bc', K)
    DD = jnp.einsum('iikk->ik', T)
    Y2 = (G + G.T + Es + Es.T + Fs + Fs.T + A4 + A4.T
          + HD + HD.T + KD + KD.T + DD + DD.T)

    # -- degree 3: classes {a,b,c}: x_e (either copy) times an
    # off-diagonal slot; the Q-diag copies ride the same symmetrizer
    # through the diagonal planes D1/D2 of T --
    D1n = jnp.einsum('eefg->efg', T) * moff[None, :, :]
    D2n = jnp.einsum('fgee->fge', T) * moff[:, :, None]
    Hp = Hn + D1n
    Kp = Kn + D2n
    HH = Hp + jnp.swapaxes(Hp, 1, 2)
    Ka = jnp.transpose(Kp, (2, 0, 1))
    KK = Ka + jnp.swapaxes(Ka, 1, 2)
    S3 = HH + KK
    Y3 = (S3 + jnp.transpose(S3, (1, 0, 2)) + jnp.transpose(S3, (2, 1, 0)))

    # -- degree 4: full S4 symmetrization of the off-diagonal Q-block --
    P1 = Tn + jnp.transpose(Tn, (1, 0, 2, 3))
    P2 = P1 + jnp.transpose(P1, (0, 1, 3, 2))
    P3 = P2 + jnp.transpose(P2, (2, 3, 0, 1))
    Y4 = (P3 + jnp.transpose(P3, (0, 2, 1, 3))
          + jnp.transpose(P3, (0, 3, 2, 1)))
    return y0, y1, Y2, Y3, Y4


def _adjoint_tensor(y0, y1, Y2, Y3, Y4, q):
    """(n~, n~) matrix W with W[u, v] = class value of (u, v).

    Pure masked broadcasts — the inverse of the class map is evaluated
    by index-coincidence selection, never by scatter.  Q-grid diagonal
    slots are the second x_a copies, so their coincidence branches
    route to y1/Y2/Y3 instead of y0/y1/Y2.
    """
    eye = jnp.eye(q, dtype=bool)

    E_w = jnp.where(eye, y1[:, None], Y2)     # (const, Q): diag = {i}
    G_w = jnp.where(eye, y0, Y2)              # (L, L)

    # (L, Q) block H_w[b, i, j]
    b3 = jax.lax.broadcasted_iota(jnp.int32, (q, q, q), 0)
    i3 = jax.lax.broadcasted_iota(jnp.int32, (q, q, q), 1)
    j3 = jax.lax.broadcasted_iota(jnp.int32, (q, q, q), 2)
    y1_b = y1[:, None, None]
    y1_i = y1[None, :, None]
    y1_j = y1[None, None, :]
    Y2_bi = Y2[:, :, None]
    H_w = jnp.where(i3 == j3,
                    jnp.where(b3 == i3, y0, Y2_bi),      # (x_b, x_i copy)
                    jnp.where(b3 == i3, y1_j,
                              jnp.where(b3 == j3, y1_i, Y3)))

    # (Q, Q) block T_w[i, j, k, l]
    i4 = jax.lax.broadcasted_iota(jnp.int32, (q, q, q, q), 0)
    j4 = jax.lax.broadcasted_iota(jnp.int32, (q, q, q, q), 1)
    k4 = jax.lax.broadcasted_iota(jnp.int32, (q, q, q, q), 2)
    l4 = jax.lax.broadcasted_iota(jnp.int32, (q, q, q, q), 3)
    Y2_ik = Y2[:, None, :, None]
    Y2_il = Y2[:, None, None, :]
    Y2_jk = Y2[None, :, :, None]
    Y2_jl = Y2[None, :, None, :]
    y1_l4 = y1[None, None, None, :]
    y1_k4 = y1[None, None, :, None]
    y1_j4 = y1[None, :, None, None]
    y1_i4 = y1[:, None, None, None]
    Y3_ikl = Y3[:, None, :, :]                 # value Y3[i, k, l]
    Y3_ijk = Y3[:, :, :, None]                 # value Y3[i, j, k]
    fd = i4 == j4
    sd = k4 == l4
    same = ((i4 == k4) & (j4 == l4)) | ((i4 == l4) & (j4 == k4))
    T_w = jnp.where(
        fd & sd,
        jnp.where(i4 == k4, y0, Y2_ik),        # (x_i copy, x_k copy)
        jnp.where(
            fd,                                # (x_i copy, x_k x_l)
            jnp.where(i4 == k4, y1_l4,
                      jnp.where(i4 == l4, y1_k4, Y3_ikl)),
            jnp.where(
                sd,                            # (x_i x_j, x_k copy)
                jnp.where(k4 == i4, y1_j4,
                          jnp.where(k4 == j4, y1_i4, Y3_ijk)),
                jnp.where(same, y0,
                          jnp.where(i4 == k4, Y2_jl,
                                    jnp.where(i4 == l4, Y2_jk,
                                              jnp.where(j4 == k4, Y2_il,
                                                        jnp.where(j4 == l4, Y2_ik,
                                                                  Y4))))))))

    two = jnp.ones((2,), dtype=Y4.dtype)
    rowsC = jnp.concatenate([
        jnp.full((2, 2), y0, dtype=Y4.dtype), two[:, None] * y1[None, :],
        two[:, None] * E_w.reshape(1, -1)], axis=1)
    rowsL = jnp.concatenate([y1[:, None] * two[None, :], G_w,
                             H_w.reshape(q, q * q)], axis=1)
    rowsQ = jnp.concatenate([E_w.reshape(-1, 1) * two[None, :],
                             jnp.transpose(H_w, (1, 2, 0)).reshape(q * q, q),
                             T_w.reshape(q * q, q * q)], axis=1)
    return jnp.concatenate([rowsC, rowsL, rowsQ], axis=0)


def _flatten(y0, y1, Y2, Y3, Y4):
    return jnp.concatenate([jnp.reshape(y0, (1,)), y1, Y2.reshape(-1),
                            Y3.reshape(-1), Y4.reshape(-1)])


def _split(y, q):
    o1 = 1 + q
    o2 = o1 + q * q
    o3 = o2 + q ** 3
    return (y[0], y[1:o1], y[o1:o2].reshape(q, q),
            y[o2:o3].reshape(q, q, q), y[o3:].reshape(q, q, q, q))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SymDualOp:
    """Gather-free drop-in for DualOp on BQP-SOS expanded data.

    ``n`` is the expanded basis size n~ = 2 + q + q^2; ``m`` the flat
    per-degree multiplier length 1 + q + q^2 + q^3 + q^4 (``m_true``
    carries the number of distinct monomial classes for logging).
    """
    b: jax.Array               # (1+q+q^2,) dual-weighted deg<=2 prefix
    cf: jax.Array              # (f,)
    C: jax.Array               # scalar 0 (PSD-part cost is zero for BQP)
    idAAt: jax.Array           # (5,) per-degree 1/class-size scalars
    bA: jax.Array              # (n, n) dense mat(A' D^{-1} b)
    Ac: jax.Array              # scalar 0 (A @ vec(C))
    B: SparseMat
    dup0: jax.Array             # (n_orig,) first copy column of each
    dup1: jax.Array             # (n_orig,) second copy column
    q: int = dataclasses.field(metadata=dict(static=True))
    m: int = dataclasses.field(metadata=dict(static=True))
    n: int = dataclasses.field(metadata=dict(static=True))
    f: int = dataclasses.field(metadata=dict(static=True))
    m_true: int = dataclasses.field(metadata=dict(static=True))
    n_orig: int = dataclasses.field(metadata=dict(static=True))

    # ---- DualOp-compatible surface --------------------------------------
    # m-space values travel as PER-DEGREE TUPLES (y0, y1, Y2, Y3, Y4):
    # a flat concatenation would copy the q^4 block at every
    # apply/scale/adjoint boundary (~1.6 GB of extra f64 traffic per
    # cost evaluation at q = 100 — the round-4 OOM margin).  The flat
    # layout survives only at the host boundary (flatten_y) and as an
    # accepted input for compatibility.
    def apply(self, M):
        return _apply_tensor(M, self.q)

    def apply_flat(self, M):
        """Flat (m,) layout of apply() — host/test convenience only."""
        return _flatten(*self.apply(M))

    def _tup(self, y):
        return y if isinstance(y, tuple) else _split(y, self.q)

    def flatten_y(self, y):
        return _flatten(*self._tup(y))

    def adjoint(self, y):
        y0, y1, Y2, Y3, Y4 = self._tup(y)
        return _adjoint_tensor(y0, y1, Y2, Y3, Y4, self.q)

    def y_step(self, S):
        y0, y1, Y2, Y3, Y4 = self.apply(S)
        return self.scale_idAAt((y0 - self.Ac, y1, Y2, Y3, Y4))

    def dot_b(self, y):
        """<b, y>: b is supported on the degree <= 2 prefix only."""
        y0, y1, Y2, _, _ = self._tup(y)
        nb = self.b.shape[0]
        return (self.b[0] * y0 + jnp.dot(self.b[1:1 + self.q], y1)
                + jnp.dot(self.b[1 + self.q:nb], Y2.reshape(-1)))

    def scale_idAAt(self, v):
        """(AA')^{-1} v with the CONSTANT per-degree class sizes — no
        length-m idAAt array (808 MB at q = 100).  Repeated-index
        slots get the degree scalar instead of 1; they are don't-care
        (never read by adjoint, zero in b)."""
        y0, y1, Y2, Y3, Y4 = self._tup(v)
        s = self.idAAt
        return (y0 * s[0], y1 * s[1], Y2 * s[2], Y3 * s[3], Y4 * s[4])

    def symmetrize(self, Y, renorm: bool = True):
        """Project a (p, n~) factor onto the slot-symmetric subspace
        (duplicate copies averaged), optionally renormalizing columns.

        On this subspace the expanded ADMM reproduces the reference
        trajectory EXACTLY (see solve_bqp_sos_dual); off it, the
        asymmetric modes see only the weak sigma-scale entrywise
        penalty, the inner RTR stalls at ~100x higher gradnorm and the
        sigma controller limit-cycles (observed at q = 60).  Random
        inits and accumulated f32 tCG noise leave the subspace, so the
        driver calls this once per outer iteration — pure transposes,
        diagonal extracts and block concats, no gathers.
        """
        return _symmetrize_jit(jnp.asarray(Y), self.q, bool(renorm))

    def compress(self, M_dev):
        """Original-basis (n_orig x n_orig) matrix from an expanded
        one: read the representative slots and undo the 1/4 lift
        scaling.  Row-take + column-take (slice gathers); once per
        outer iteration from the certificate, never in the hot loop."""
        return 4.0 * M_dev[self.dup0][:, self.dup0]

    def lift_vecs(self, V: np.ndarray) -> np.ndarray:
        """Host lift of original-basis (n_orig, k) eigenvectors into
        unit expanded vectors (each copy slot gets v/sqrt(2))."""
        out = np.zeros((self.n, V.shape[1]), dtype=V.dtype)
        s = np.asarray(V) / np.sqrt(2.0)
        out[np.asarray(self.dup0)] = s
        out[np.asarray(self.dup1)] = s
        return out

    def symmetrize_mat(self, M):
        """Project an (n~, n~) matrix (the ADMM multiplier / primal
        recovery) onto the duplicate-symmetric subspace: average over
        each entry's 4-element copy orbit, i.e. the column projector
        applied along both axes.  Without this the multiplier
        accumulates asymmetric components that shift the AL stationary
        point off-subspace and floor pinf at the junk's magnitude
        (observed ~0.5-1 at q = 60 after ~40 outer iterations)."""
        M = _symmetrize_jit(jnp.asarray(M), self.q, False)
        return _symmetrize_jit(M.T, self.q, False).T

    # ---- construction ---------------------------------------------------
    @staticmethod
    def build_bqpsos(Q: np.ndarray, e: np.ndarray, q: int) -> "SymDualOp":
        """Expanded-basis operator for min x'Qx + e'x, x in {-1,1}^q.

        Mirrors frontends.sos.assemble_bqpsos semantics (reference
        bqpsos.m + README.md:261-271 free lower-bound variable) on the
        expanded basis.  b is NOT normalized — callers divide by
        max|b| as the reference examples do.
        """
        Q = np.asarray(Q, dtype=np.float64)
        e = np.asarray(e, dtype=np.float64).ravel()
        nn = 2 + q + q * q
        flat_m = 1 + q + q ** 2 + q ** 3 + q ** 4
        m_true = _num_classes(q)

        # dual-weighted flat b: per-slot values summing to the class b
        b1 = e
        B2 = np.asarray(Q, dtype=np.float64).copy()
        np.fill_diagonal(B2, 0.0)
        b_flat = np.concatenate([[np.trace(Q)], b1, B2.reshape(-1)])

        # every class size is exactly 4x the original basis's
        # (two copies per column; validated against the expanded
        # sparse bincount in tests/test_symdual.py): the original
        # sizes are mb (deg 0, all-diagonal), 2q (deg 1 and 2), and 6
        # (deg 3 and 4) — src/basicfunction/bqpsos.m:17-31.  Setup
        # stays pure numpy: no compile before the solve starts.
        d0 = 4.0 * (1 + q + q * (q - 1) // 2)
        d1 = 8.0 * q
        d2 = 8.0 * q
        idAAt = 1.0 / np.array([d0, d1, d2, 24.0, 24.0])

        # bA = mat(A' (b / dAAt)): b has support only up to degree 2,
        # so the adjoint broadcast needs no q^4 tensor — numpy suffices
        bA = _adjoint_np_deg2(np.trace(Q) / d0, e / d1, 2.0 * B2 / d2, q)

        # NO free lower-bound block: on the expanded basis the dual
        # constraint it would impose (y_0 = 1) is already pinned by the
        # unit diagonal through the class-0 structure, and a redundant
        # equality makes the ADMM multiplier w drift in the degenerate
        # subspace — observed as a fixed ~1e-6-relative duality-gap
        # floor (obj = cf'w + sum(z) with an inconsistent w).  Without
        # the block, obj = sum(z) equals b'y exactly at optimality and
        # the recovered bound is b'y itself (matching the reference
        # free-variable value, README.md:261-271).
        import scipy.sparse as sp
        Bmat = SparseMat.from_scipy(sp.coo_matrix((flat_m, 0)))

        # original <-> expanded column maps (for the exact compressed
        # certificate): original basis order [1, x_a, x_{ab} (a<b,
        # column-major)], matching frontends/sos.bqpsos
        o = 2 + q
        iu, ju = np.triu_indices(q, k=1)
        order = np.lexsort((iu, ju))
        pa, pb = iu[order], ju[order]
        rep = np.concatenate([[0], 2 + np.arange(q), o + pa * q + pb])
        dup = np.concatenate([[1], o + np.arange(q) * (q + 1),
                              o + pb * q + pa])
        n_orig = rep.shape[0]

        return SymDualOp(
            b=jnp.asarray(b_flat), cf=jnp.zeros(0, dtype=jnp.float64),
            C=jnp.zeros((), dtype=jnp.float64),
            idAAt=jnp.asarray(idAAt), bA=jnp.asarray(bA),
            Ac=jnp.zeros((), dtype=jnp.float64), B=Bmat,
            dup0=jnp.asarray(rep, dtype=jnp.int32),
            dup1=jnp.asarray(dup, dtype=jnp.int32),
            q=q, m=flat_m, n=nn, f=0, m_true=m_true, n_orig=n_orig)


@partial(jax.jit, static_argnums=(1, 2))
def _symmetrize_jit(Y, q: int, renorm: bool):
    o = 2 + q
    c = 0.5 * (Y[:, 0] + Y[:, 1])
    L = Y[:, 2:o]
    Qb = Y[:, o:].reshape(-1, q, q)
    d = jnp.einsum('pii->pi', Qb)
    La = 0.5 * (L + d)
    Qs = 0.5 * (Qb + jnp.swapaxes(Qb, 1, 2))
    eye = jnp.eye(q, dtype=Y.dtype)
    Qs = Qs * (1.0 - eye)[None] + La[:, :, None] * eye[None]
    out = jnp.concatenate(
        [c[:, None], c[:, None], La, Qs.reshape(Y.shape[0], q * q)],
        axis=1)
    if renorm:
        nrm = jnp.linalg.norm(out, axis=0, keepdims=True)
        out = out / jnp.maximum(nrm, 1e-30)
    return out


def _num_classes(q: int) -> int:
    from math import comb
    return 1 + q + comb(q, 2) + comb(q, 3) + comb(q, 4)


def _adjoint_np_deg2(y0: float, y1: np.ndarray, Y2: np.ndarray,
                     q: int) -> np.ndarray:
    """Host-numpy adjoint for multipliers supported on degree <= 2
    (Y3 = Y4 = 0) — the bA precompute.  Same class map as
    _adjoint_tensor; patterns are written lowest-priority first so
    later writes win, avoiding the q^4 where-chain temporaries."""
    Y2 = np.asarray(Y2, dtype=np.float64)
    y1 = np.asarray(y1, dtype=np.float64)
    eye = np.eye(q, dtype=bool)
    E_w = np.where(eye, y1[:, None], Y2)
    G_w = np.where(eye, y0, Y2)

    H_w = np.zeros((q, q, q))
    for c in range(q):
        H_w[c, :, c] = y1              # b == j  -> y1[i]
    for c in range(q):
        H_w[c, c, :] = y1              # b == i  -> y1[j]
    for c in range(q):
        H_w[:, c, c] = Y2[:, c]        # i == j  -> (x_b, x_i copy)
    ii = np.arange(q)
    H_w[ii, ii, ii] = y0

    T_w = np.zeros((q, q, q, q))
    for c in range(q):
        T_w[:, c, :, c] = Y2           # j == l -> Y2[i, k]
    for c in range(q):
        T_w[:, c, c, :] = Y2           # j == k -> Y2[i, l]
    for c in range(q):
        T_w[c, :, :, c] = Y2           # i == l -> Y2[j, k]
    for c in range(q):
        T_w[c, :, c, :] = Y2           # i == k -> Y2[j, l]
    i2, j2 = np.meshgrid(ii, ii, indexing="ij")
    T_w[i2, j2, i2, j2] = y0           # same pair
    T_w[i2, j2, j2, i2] = y0
    for c in range(q):
        T_w[:, :, c, c] = 0.0          # (x_i x_j, x_k copy): Y3 = 0
        T_w[c, c, :, :] = 0.0          # (x_i copy, x_k x_l): Y3 = 0
    for c in range(q):
        T_w[:, c, c, c] = y1           # sd, k == j -> y1[i]
        T_w[c, :, c, c] = y1           # sd, k == i -> y1[j]
        T_w[c, c, :, c] = y1           # fd, i == l -> y1[k]
        T_w[c, c, c, :] = y1           # fd, i == k -> y1[l]
    T_w[i2, i2, j2, j2] = Y2           # (x_i copy, x_k copy)
    T_w[ii, ii, ii, ii] = y0

    rowsC = np.concatenate([np.full((2, 2), y0),
                            np.broadcast_to(y1, (2, q)),
                            np.broadcast_to(E_w.reshape(-1), (2, q * q))],
                           axis=1)
    rowsL = np.concatenate([np.broadcast_to(y1[:, None], (q, 2)), G_w,
                            H_w.reshape(q, q * q)], axis=1)
    rowsQ = np.concatenate([np.broadcast_to(E_w.reshape(-1, 1),
                                            (q * q, 2)),
                            np.transpose(H_w, (1, 2, 0)).reshape(q * q, q),
                            T_w.reshape(q * q, q * q)], axis=1)
    return np.concatenate([rowsC, rowsL, rowsQ], axis=0)


def _dontcare_mask(q: int) -> np.ndarray:
    """Boolean mask over the flat layout marking repeated-index slots."""
    m2 = np.eye(q, dtype=bool).reshape(-1)
    i3, j3, k3 = np.meshgrid(*([np.arange(q)] * 3), indexing="ij")
    m3 = ((i3 == j3) | (i3 == k3) | (j3 == k3)).reshape(-1)
    i4, j4, k4, l4 = np.meshgrid(*([np.arange(q)] * 4), indexing="ij")
    m4 = ((i4 == j4) | (i4 == k4) | (i4 == l4) |
          (j4 == k4) | (j4 == l4) | (k4 == l4)).reshape(-1)
    return np.concatenate([np.zeros(1 + q, dtype=bool), m2, m3, m4])


def expanded_masks(q: int) -> np.ndarray:
    """Monomial bitmask of every expanded basis column (host helper for
    the validation generator and tests).  Layout: two constants, the
    x_a first copies, then the q x q grid whose diagonal holds the
    x_a SECOND copies."""
    assert q <= 62
    masks = np.zeros(2 + q + q * q, dtype=np.uint64)
    masks[2:2 + q] = 1 << np.arange(q, dtype=np.uint64)
    ii, jj = np.meshgrid(np.arange(q), np.arange(q), indexing="ij")
    qm = (1 << ii.astype(np.uint64)) ^ (1 << jj.astype(np.uint64))
    qm[np.arange(q), np.arange(q)] = 1 << np.arange(q, dtype=np.uint64)
    masks[2 + q:] = qm.reshape(-1)
    return masks


def bqpsos_expanded_sparse(Q: np.ndarray, e: np.ndarray, q: int):
    """Expanded-basis BQP-SOS data as SPARSE SeDuMi-style arrays, for
    small-q validation of SymDualOp through the generic DualOp path.

    Returns (A_full, b, c, nn, f=1, dAAt) exactly as
    frontends.sos.assemble_bqpsos does for the original basis.
    """
    import scipy.sparse as sp
    from ..frontends.monomials import monomial_basis

    Q = np.asarray(Q, dtype=np.float64)
    e = np.asarray(e, dtype=np.float64).ravel()
    nn = 2 + q + q * q
    sp4 = monomial_basis(q, 4, max_power=1)
    lsp = sp4.shape[1]
    pow2 = (1 << np.arange(q, dtype=np.uint64))
    masks4 = (sp4.astype(np.uint64).T * pow2).sum(axis=1)
    order4 = np.argsort(masks4, kind="stable")
    sorted4 = masks4[order4]

    em = expanded_masks(q)
    iu, ju = np.meshgrid(np.arange(nn), np.arange(nn), indexing="ij")
    xm = np.bitwise_xor(em[iu.reshape(-1)], em[ju.reshape(-1)])
    rows = order4[np.searchsorted(sorted4, xm)]
    cols = ju.reshape(-1) * nn + iu.reshape(-1)   # column-major like _ent
    vals = np.ones(rows.shape[0])
    dAAt = np.bincount(rows, minlength=lsp).astype(np.float64)
    A = sp.coo_matrix((vals, (rows, cols)), shape=(lsp, nn * nn)).tocsr()

    b = np.zeros(lsp)
    b[0] = np.trace(Q)
    mask1 = 1 << np.arange(q, dtype=np.uint64)
    b[order4[np.searchsorted(sorted4, mask1)]] = e
    i2, j2 = np.triu_indices(q, k=1)
    b[order4[np.searchsorted(
        sorted4, (1 << i2.astype(np.uint64)) ^ (1 << j2.astype(np.uint64)))]] \
        = 2.0 * Q[i2, j2]

    v = sp.coo_matrix(([1.0], ([0], [0])), shape=(lsp, 1))
    A_full = sp.hstack([v, A]).tocsr()
    c = np.zeros(1 + nn * nn)
    c[0] = 1.0
    return A_full, b, c, nn, 1, dAAt
