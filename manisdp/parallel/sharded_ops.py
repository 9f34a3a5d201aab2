"""Mesh-sharded constraint operator — the sparse AL hot path on many devices.

The reference's hot ops (``A*x``, ``At*w``, ``A'A vec(Y'U)`` of
src/primal/ManiSDP_unitdiag.m:152-171) are single-process MATLAB sparse
BLAS.  Here they shard over a ``jax.sharding.Mesh`` axis (``model``):

  layout   : pattern entries P and A-entries are partitioned BY PATTERN
             ID (the ConstraintOp already carries an a2p-sorted entry
             ordering), so each device owns a contiguous slice of P plus
             exactly the A-entries that touch it.  The factor Y (p, n)
             is small (p ~ tens) and stays replicated.
  adjoint  : mat(A'w) on P = per-device segment-sum by LOCAL pattern id
             -> zero communication.
  forward  : A(vec(Y'U)) = per-device partial sums by constraint row k
             -> one psum((m,)) over the mesh axis.
  matmat   : Y @ mat(vals on P) = per-device scatter into (p, n)
             -> one psum((p, n)).
  certmv   : mat(vals) @ V -> psum((n, k)) — the LOBPCG certificate
             matvec, so the whole eigensolve runs under shard_map.

All gathers read replicated arrays (Y, w, V) at local indices — the only
communication is reductions, which XLA lowers to all-reduces.
Padding entries carry value 0 and repeat their slice's last index so
every per-shard segment-sum keeps ``indices_are_sorted=True``.

This class implements the same operator protocol as
``ops.sparse.ConstraintOp`` (see the protocol note there), so the AL
problem builders in ``solvers/primal_al.py`` run unchanged on top of it
— the methods just carry ``lax.psum`` over the mesh axis and must be
called inside ``shard_map``.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import NamedSharding, PartitionSpec as P

from ..ops.sparse import ConstraintOp, gather_cols, pair_dots, scatter_cols


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ShardedConstraintOp:
    """ConstraintOp partitioned by pattern id over mesh axis ``axis``.

    Array leaves carry a leading device axis (ndev, L); inside
    ``shard_map`` each device sees its (1, L) slice.
    """
    # pattern slice, (ndev, Lp): sorted by (j, i) within each slice
    pat_i: jax.Array
    pat_j: jax.Array
    pat_c: jax.Array       # c restricted to P (padding -> 0)
    # A-entries in a2p-sorted order, (ndev, La): locp ascending
    kp: jax.Array          # constraint row of each entry
    vp: jax.Array          # value (padding -> 0)
    locp: jax.Array        # local pattern index in [0, Lp)
    # the same A-entries k-sorted within each slice (forward op)
    ks: jax.Array
    vs: jax.Array
    locps: jax.Array
    b: jax.Array           # (m,) replicated
    m: int = dataclasses.field(metadata=dict(static=True))
    n: int = dataclasses.field(metadata=dict(static=True))
    axis: str = dataclasses.field(default="model",
                                  metadata=dict(static=True))

    # -- construction ------------------------------------------------------
    @staticmethod
    def build(op: ConstraintOp, ndev: int,
              axis: str = "model") -> "ShardedConstraintOp":
        """Host-side partition of a ConstraintOp into ndev slices."""
        pi = np.asarray(op.pat.i)
        pj = np.asarray(op.pat.j)
        pc = np.asarray(op.pat.v)
        nnzP = pi.shape[0]
        Lp = -(-nnzP // ndev)

        def pad_to(x, L, fill):
            out = np.full(L, fill, dtype=x.dtype)
            out[:x.shape[0]] = x
            return out

        # pattern slices; padding repeats the last (i, j) with c = 0 so
        # per-slice (j, i) sortedness survives
        pat_i = np.empty((ndev, Lp), dtype=np.int32)
        pat_j = np.empty((ndev, Lp), dtype=np.int32)
        pat_c = np.zeros((ndev, Lp), dtype=np.float64)
        for d in range(ndev):
            lo, hi = d * Lp, min((d + 1) * Lp, nnzP)
            if hi <= lo:           # fully padded slice (tiny problems)
                pat_i[d] = pi[-1]
                pat_j[d] = pj[-1]
                continue
            pat_i[d] = pad_to(pi[lo:hi], Lp, pi[hi - 1])
            pat_j[d] = pad_to(pj[lo:hi], Lp, pj[hi - 1])
            pat_c[d, :hi - lo] = pc[lo:hi]

        # A-entries, a2p-sorted: slice d owns entries with pattern id in
        # [d*Lp, (d+1)*Lp)
        a2ps = np.asarray(op.a2p_sorted)
        kp_g = np.asarray(op.kp)
        vp_g = np.asarray(op.vp)
        cuts = np.searchsorted(a2ps, np.arange(1, ndev) * Lp)
        starts = np.concatenate([[0], cuts])
        ends = np.concatenate([cuts, [a2ps.shape[0]]])
        La = max(int((ends - starts).max()), 1)

        kp = np.zeros((ndev, La), dtype=np.int32)
        vp = np.zeros((ndev, La), dtype=np.float64)
        locp = np.zeros((ndev, La), dtype=np.int32)
        ks = np.zeros((ndev, La), dtype=np.int32)
        vs = np.zeros((ndev, La), dtype=np.float64)
        locps = np.zeros((ndev, La), dtype=np.int32)
        for d in range(ndev):
            lo, hi = starts[d], ends[d]
            cnt = hi - lo
            k_d = kp_g[lo:hi]
            v_d = vp_g[lo:hi]
            l_d = (a2ps[lo:hi] - d * Lp).astype(np.int32)
            if cnt == 0:
                continue
            kp[d] = pad_to(k_d, La, k_d[-1])
            vp[d, :cnt] = v_d
            locp[d] = pad_to(l_d, La, l_d[-1])
            ordk = np.argsort(k_d, kind="stable")
            ks[d] = pad_to(k_d[ordk], La, k_d[ordk][-1])
            vs[d, :cnt] = v_d[ordk]
            locps[d] = pad_to(l_d[ordk], La, l_d[ordk][-1])

        return ShardedConstraintOp(
            pat_i=jnp.asarray(pat_i), pat_j=jnp.asarray(pat_j),
            pat_c=jnp.asarray(pat_c),
            kp=jnp.asarray(kp), vp=jnp.asarray(vp), locp=jnp.asarray(locp),
            ks=jnp.asarray(ks), vs=jnp.asarray(vs),
            locps=jnp.asarray(locps),
            b=jnp.asarray(np.asarray(op.b)),
            m=op.m, n=op.n, axis=axis)

    # -- sharding metadata -------------------------------------------------
    def specs(self) -> "ShardedConstraintOp":
        """A matching pytree of shard_map PartitionSpecs."""
        ax = P(self.axis)
        return dataclasses.replace(
            self, pat_i=ax, pat_j=ax, pat_c=ax, kp=ax, vp=ax, locp=ax,
            ks=ax, vs=ax, locps=ax, b=P())

    def shardings(self, mesh) -> "ShardedConstraintOp":
        """NamedShardings for jax.device_put onto ``mesh``."""
        return jax.tree_util.tree_map(
            lambda s: NamedSharding(mesh, s), self.specs(),
            is_leaf=lambda x: isinstance(x, P))

    def astype(self, dtype) -> "ShardedConstraintOp":
        cast = lambda x: x.astype(dtype) \
            if jnp.issubdtype(x.dtype, jnp.floating) else x
        return dataclasses.replace(
            self, pat_c=cast(self.pat_c), vp=cast(self.vp),
            vs=cast(self.vs), b=cast(self.b))

    @property
    def nnzP_local(self) -> int:
        return self.pat_i.shape[-1]

    def _psum(self, x):
        return lax.psum(x, self.axis)

    # -- operator protocol (call inside shard_map) ---------------------------
    @property
    def c_pattern(self):
        return self.pat_c[0]

    def pattern_pair_dots(self, Y, U=None):
        return pair_dots(Y, Y if U is None else U,
                         self.pat_i[0], self.pat_j[0])

    def dot_pattern(self, u, v):
        return self._psum(jnp.dot(u, v))

    def apply_from_e(self, e):
        w_loc = jax.ops.segment_sum(
            self.vs[0] * jnp.take(e, self.locps[0]), self.ks[0],
            num_segments=self.m, indices_are_sorted=True)
        return self._psum(w_loc)

    def apply_factored(self, Y, U=None):
        return self.apply_from_e(self.pattern_pair_dots(Y, U))

    def adjoint_on_pattern(self, w):
        # local pattern ids ascend, so this segment-sum is sorted and
        # needs NO communication — the payoff of partitioning by a2p
        return jax.ops.segment_sum(
            self.vp[0] * jnp.take(w, self.kp[0]), self.locp[0],
            num_segments=self.nnzP_local, indices_are_sorted=True)

    def es_vals(self, w, sigma):
        return self.pat_c[0] + sigma * self.adjoint_on_pattern(w)

    def s_vals(self, y):
        return self.pat_c[0] - self.adjoint_on_pattern(y)

    def colsum_pattern(self, vals):
        loc = jax.ops.segment_sum(vals, self.pat_j[0],
                                  num_segments=self.n,
                                  indices_are_sorted=True)
        return self._psum(loc)

    def matmat_pattern(self, Y, vals):
        loc = scatter_cols(vals, self.pat_i[0], self.pat_j[0], Y, self.n,
                           sorted_out=True)
        return self._psum(loc)

    def matvec_pattern(self, V, vals):
        contrib = jnp.take(V, self.pat_i[0], axis=0) * vals[:, None]
        loc = jax.ops.segment_sum(contrib, self.pat_j[0],
                                  num_segments=self.n,
                                  indices_are_sorted=True)
        return self._psum(loc)

    # -- residual-space protocol (m-vectors, replicated across shards) ------
    def res_zeros(self):
        return jnp.zeros(self.m)

    def res_from_mvec(self, y):
        return jnp.asarray(np.asarray(y, dtype=np.float64).ravel())

    def res_to_mvec(self, y_dev):
        return np.asarray(jax.device_get(y_dev))

    def dot_res(self, u, v):
        # u, v replicated (m,) vectors: a local dot, no psum
        return jnp.dot(u, v)

    def norm_res(self, u):
        return jnp.linalg.norm(u)
