"""Mesh-sharded expanded-pair-basis SOS-dual operator.

The q^4 tensors are THE memory wall of the large-q SOS dual
(ops/symdual.py): at q = 100 every f64 (q,q,q,q) array is ~800 MB and
at q = 130 (the tail of the reference's own table, m up to 11.7M) it
is 2.3 GB, with several alive per Hessian-vector product — this module
is the multi-device path.

Layout: every q^4 object is sharded over ONE mesh axis (``model``) on
its LEADING grid index —

  matrix   : the expanded (n~, n~) matrix M (n~ = 2 + q + q^2, so M is
             itself a q^4-sized object) splits into ``top`` = the
             first 2 + q rows (replicated, O(q^3)) and ``rowsQ`` = the
             q x q grid rows reshaped (q, q, n~) and sharded on axis 0
             -> each device holds (q/D, q, n~).
  m-space  : the per-degree multiplier tuple (y0, y1, Y2, Y3, Y4)
             keeps y0..Y3 replicated (<= q^3) and shards Y4 (q,q,q,q)
             on axis 0.

``apply`` (class sums, symdual._apply_tensor) and ``adjoint`` (masked
broadcast, symdual._adjoint_tensor) then decompose as:

  - every diagonal-coincidence einsum ('iiii->', 'ajaj->', ...) reads
    the device's own row block against an offset ``dynamic_slice`` of
    the global axes — zero communication, one ``psum`` per replicated
    output (y0..Y3, all O(q^3) or smaller);
  - the degree-4 S4 symmetrization needs exactly TWO cross-shard
    transposes ((1,0,2,3) and (2,3,0,1)); each is one
    ``lax.all_to_all`` of the q^4 block plus a local
    transpose.  The remaining three transposes fix the leading axis
    and stay device-local;
  - ``adjoint`` is communication-free: the device's (q/D, q, n~) output
    rows depend only on the replicated y0..Y3 and its own Y4 block
    (the leading-axis iota is offset by ``axis_index * q/D``).

Per-device high-water memory is q^4/D + O(q^3) — 8 devices hold
q = 130 (2.3 GB f64 per q^4 tensor globally, 285 MB per device).

Reference semantics: same class-sum partition as ops/symdual.py
(src/basicfunction/bqpsos.m:17-31); communication design follows the
scaling-book recipe — shard one named axis, let XLA lower
psum/all_to_all to the interconnect's collectives, keep every einsum's
last axis fixed so no local transpose moves the minor-most dimension (a
transpose that moves it is a full strided copy).

Validated bit-for-bit against the single-device operator in
tests/test_symdual_sharded.py on the virtual 8-device CPU mesh.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P


def _sl(x, axis, off, size):
    return lax.dynamic_slice_in_dim(x, off, size, axis=axis)


def _pad_rows(block, q, off):
    """Place a (q/D, ...) row block at row offset ``off`` of a zeros
    (q, ...) array (combined with psum this replicates the assembly)."""
    out = jnp.zeros((q,) + block.shape[1:], dtype=block.dtype)
    return lax.dynamic_update_slice_in_dim(out, block, off, axis=0)


def _pad_cols(block, q, off):
    out = jnp.zeros(block.shape[:1] + (q,) + block.shape[2:],
                    dtype=block.dtype)
    return lax.dynamic_update_slice_in_dim(out, block, off, axis=1)


def apply_sharded(top, rowsQ, q: int, axis: str = "model"):
    """Per-degree class sums of the sharded expanded matrix.

    top   : (2 + q, n~) replicated — the constant + linear rows.
    rowsQ : (q/D, q, n~) local — this device's Q-grid row block.

    Returns (y0, y1, Y2, Y3, Y4_local) with y0..Y3 replicated and
    Y4_local (q/D, q, q, q).  Call inside ``shard_map``.
    """
    o = 2 + q
    ql = rowsQ.shape[0]
    off = lax.axis_index(axis) * ql
    dt = rowsQ.dtype

    s = top[:2, :2]
    u = top[:2, 2:o]
    E = top[:2, o:].reshape(2, q, q)
    uT = top[2:o, :2]
    G = top[2:o, 2:o]
    H = top[2:o, o:].reshape(q, q, q)
    F = rowsQ[:, :, :2]                       # (ql, q, 2)
    K = rowsQ[:, :, 2:o]                      # (ql, q, q)   [i, j, b]
    T = rowsQ[:, :, o:].reshape(ql, q, q, q)  # (ql, q, q, q)

    moff = 1.0 - jnp.eye(q, dtype=dt)
    moff_l = _sl(moff, 0, off, ql)            # (ql, q)
    Tn = T * moff_l[:, :, None, None] * moff[None, None, :, :]
    Hn = H * moff[None, :, :]
    Kn = K * moff_l[:, :, None]

    # -- degree 0 --
    y0_rep = jnp.sum(s) + jnp.trace(G) + jnp.einsum('aaa->', H)
    K_dd = _sl(_sl(K, 1, off, ql), 2, off, ql)
    T_dd = _sl(_sl(_sl(T, 1, off, ql), 2, off, ql), 3, off, ql)
    y0_loc = (jnp.einsum('aaa->', K_dd) + jnp.einsum('aaaa->', T_dd)
              + jnp.einsum('ajaj->', _sl(Tn, 2, off, ql))
              + jnp.einsum('ajja->', _sl(Tn, 3, off, ql)))
    y0 = y0_rep + lax.psum(y0_loc, axis)

    # -- degree 1 --
    y1_rep = (jnp.sum(u, axis=0) + jnp.sum(uT, axis=1)
              + jnp.einsum('sii->i', E)
              + jnp.einsum('iia->a', Hn) + jnp.einsum('jaj->a', Hn))
    y1_loc = (jnp.einsum('bab->a', _sl(Kn, 2, off, ql))      # 'iai->a'
              + jnp.einsum('ccca->a', _sl(_sl(T, 1, off, ql), 2, off, ql))
              + jnp.einsum('ccac->a', _sl(_sl(T, 1, off, ql), 3, off, ql))
              + jnp.einsum('cacc->a', _sl(_sl(T, 2, off, ql), 3, off, ql)))
    y1_blk = (jnp.einsum('aas->a', _sl(F, 1, off, ql))       # 'iis->i'
              + jnp.einsum('ajj->a', Kn)
              + jnp.einsum('accc->a', T)
              - 4.0 * jnp.einsum('aaaa->a', T_dd))
    y1 = y1_rep + lax.psum(y1_loc + _pad_rows(y1_blk, q, off), axis)

    # -- degree 2 --
    Es = jnp.sum(E, axis=0)
    HD = jnp.einsum('abb->ab', H)
    A4_blk = jnp.einsum('acbc->ab', Tn) + jnp.einsum('accb->ab', Tn)
    # summed index c lives on BOTH a local axis (0) and a global axis
    # (3 resp. 2) — slice the global one to this device's block
    A4_sum = (jnp.einsum('cabc->ab', _sl(Tn, 3, off, ql))
              + jnp.einsum('cacb->ab', _sl(Tn, 2, off, ql)))
    A4 = lax.psum(A4_sum + _pad_rows(A4_blk, q, off), axis)
    Fs_blk = jnp.sum(F, axis=2)                               # (ql, q)
    KD_blk = jnp.einsum('ccb->bc', _sl(K, 1, off, ql))        # (q, ql)
    DD_blk = jnp.einsum('aakk->ak', _sl(T, 1, off, ql))       # (ql, q)
    FKD = lax.psum(_pad_rows(Fs_blk + DD_blk, q, off)
                   + _pad_cols(KD_blk, q, off), axis)
    half2 = G + Es + HD + A4 + FKD
    Y2 = half2 + half2.T

    # -- degree 3 --
    D1n_blk = jnp.einsum('eefg->efg', _sl(T, 1, off, ql))     # (ql, q, q)
    D2n_blk = jnp.einsum('agee->age', T)                      # (ql, q, q)
    # assemble Hp/Kp replicated: Hn is replicated already; D1n and
    # Kp = Kn + D2n are local-row blocks assembled by pad + psum
    D1n = lax.psum(_pad_rows(D1n_blk, q, off), axis) * moff[None, :, :]
    Kp = lax.psum(_pad_rows(Kn + D2n_blk * moff_l[:, :, None], q, off),
                  axis)
    Hp = Hn + D1n
    HH = Hp + jnp.swapaxes(Hp, 1, 2)
    Ka = jnp.transpose(Kp, (2, 0, 1))
    KK = Ka + jnp.swapaxes(Ka, 1, 2)
    S3 = HH + KK
    Y3 = (S3 + jnp.transpose(S3, (1, 0, 2))
          + jnp.transpose(S3, (2, 1, 0)))

    # -- degree 4: S4 symmetrization, two cross-shard transposes --
    x1 = lax.all_to_all(Tn, axis, split_axis=1, concat_axis=0,
                        tiled=True)                 # Tn[:, blk, :, :]
    P1 = Tn + jnp.transpose(x1, (1, 0, 2, 3))
    P2 = P1 + jnp.transpose(P1, (0, 1, 3, 2))
    x2 = lax.all_to_all(P2, axis, split_axis=2, concat_axis=0,
                        tiled=True)                 # P2[:, :, blk, :]
    P3 = P2 + jnp.transpose(x2, (2, 3, 0, 1))
    Y4 = (P3 + jnp.transpose(P3, (0, 2, 1, 3))
          + jnp.transpose(P3, (0, 3, 2, 1)))
    return y0, y1, Y2, Y3, Y4


def adjoint_sharded(y0, y1, Y2, Y3, Y4, q: int, axis: str = "model"):
    """Masked-broadcast adjoint of the sharded multiplier tuple.

    y0..Y3 replicated, Y4 (q/D, q, q, q) local.  Returns
    (top (2 + q, n~) replicated, rowsQ (q/D * q, n~) local) — zero
    communication (each output row depends only on replicated inputs
    and the local Y4 block).  Call inside ``shard_map``.
    """
    ql = Y4.shape[0]
    off = lax.axis_index(axis) * ql
    dt = Y4.dtype
    eye = jnp.eye(q, dtype=bool)

    E_w = jnp.where(eye, y1[:, None], Y2)
    G_w = jnp.where(eye, y0, Y2)

    b3 = lax.broadcasted_iota(jnp.int32, (q, q, q), 0)
    i3 = lax.broadcasted_iota(jnp.int32, (q, q, q), 1)
    j3 = lax.broadcasted_iota(jnp.int32, (q, q, q), 2)
    H_w = jnp.where(i3 == j3,
                    jnp.where(b3 == i3, y0, Y2[:, :, None]),
                    jnp.where(b3 == i3, y1[None, None, :],
                              jnp.where(b3 == j3, y1[None, :, None], Y3)))

    # local T_w rows: global leading index = off + local iota
    i4 = off + lax.broadcasted_iota(jnp.int32, (ql, q, q, q), 0)
    j4 = lax.broadcasted_iota(jnp.int32, (ql, q, q, q), 1)
    k4 = lax.broadcasted_iota(jnp.int32, (ql, q, q, q), 2)
    l4 = lax.broadcasted_iota(jnp.int32, (ql, q, q, q), 3)
    Y2_l = _sl(Y2, 0, off, ql)
    Y3_l = _sl(Y3, 0, off, ql)
    y1_l = _sl(y1, 0, off, ql)
    Y2_ik = Y2_l[:, None, :, None]
    Y2_il = Y2_l[:, None, None, :]
    Y2_jk = Y2[None, :, :, None]
    Y2_jl = Y2[None, :, None, :]
    y1_l4 = y1[None, None, None, :]
    y1_k4 = y1[None, None, :, None]
    y1_j4 = y1[None, :, None, None]
    y1_i4 = y1_l[:, None, None, None]
    Y3_ikl = Y3_l[:, None, :, :]
    Y3_ijk = Y3_l[:, :, :, None]
    fd = i4 == j4
    sd = k4 == l4
    same = ((i4 == k4) & (j4 == l4)) | ((i4 == l4) & (j4 == k4))
    T_w = jnp.where(
        fd & sd,
        jnp.where(i4 == k4, y0, Y2_ik),
        jnp.where(
            fd,
            jnp.where(i4 == k4, y1_l4,
                      jnp.where(i4 == l4, y1_k4, Y3_ikl)),
            jnp.where(
                sd,
                jnp.where(k4 == i4, y1_j4,
                          jnp.where(k4 == j4, y1_i4, Y3_ijk)),
                jnp.where(same, y0,
                          jnp.where(i4 == k4, Y2_jl,
                                    jnp.where(i4 == l4, Y2_jk,
                                              jnp.where(j4 == k4, Y2_il,
                                                        jnp.where(j4 == l4,
                                                                  Y2_ik,
                                                                  Y4))))))))

    two = jnp.ones((2,), dtype=dt)
    rowsC = jnp.concatenate([
        jnp.full((2, 2), y0, dtype=dt), two[:, None] * y1[None, :],
        two[:, None] * E_w.reshape(1, -1)], axis=1)
    rowsL = jnp.concatenate([y1[:, None] * two[None, :], G_w,
                             H_w.reshape(q, q * q)], axis=1)
    top = jnp.concatenate([rowsC, rowsL], axis=0)

    E_w_l = _sl(E_w, 0, off, ql).reshape(ql * q, 1)
    H_wT_l = _sl(jnp.transpose(H_w, (1, 2, 0)), 0, off, ql) \
        .reshape(ql * q, q)
    rowsQ = jnp.concatenate(
        [E_w_l * two[None, :], H_wT_l, T_w.reshape(ql * q, q * q)],
        axis=1)
    return top, rowsQ


class ShardedSymDualOp:
    """Host-facing wrapper: jitted shard_map apply/adjoint on a mesh.

    Splits/merges the dense single-device layout at the host boundary
    for validation and the multi-chip dryrun; production drivers feed
    the sharded representation directly (never materializing the
    global q^4 arrays on one device).
    """

    def __init__(self, q: int, mesh: Mesh, axis: str = "model"):
        ndev = mesh.shape[axis]
        if q % ndev:
            raise ValueError(f"q={q} not divisible by mesh axis "
                             f"'{axis}' size {ndev}")
        self.q, self.mesh, self.axis = q, mesh, axis
        self.n = 2 + q + q * q
        rep = P()
        shard = P(axis)
        self._apply = jax.jit(jax.shard_map(
            partial(apply_sharded, q=q, axis=axis), mesh=mesh,
            in_specs=(rep, shard),
            out_specs=(rep, rep, rep, rep, shard)))
        self._adjoint = jax.jit(jax.shard_map(
            partial(adjoint_sharded, q=q, axis=axis), mesh=mesh,
            in_specs=(rep, rep, rep, rep, shard),
            out_specs=(rep, shard)))

    # -- host-boundary layout helpers ------------------------------------
    def split_matrix(self, M):
        """(n~, n~) dense -> (top, rowsQ) with rowsQ device-sharded."""
        o = 2 + self.q
        top = jnp.asarray(M[:o])
        from jax.sharding import NamedSharding
        rowsQ = jax.device_put(
            jnp.asarray(M[o:]).reshape(self.q, self.q, self.n),
            NamedSharding(self.mesh, P(self.axis)))
        return top, rowsQ

    def merge_matrix(self, top, rowsQ):
        return np.concatenate([np.asarray(top),
                               np.asarray(rowsQ).reshape(-1, self.n)])

    def apply(self, top, rowsQ):
        return self._apply(top, rowsQ)

    def adjoint(self, y):
        return self._adjoint(*y)
