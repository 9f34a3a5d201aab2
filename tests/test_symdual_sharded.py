"""Mesh-sharded SymDualOp vs the single-device operator.

The sharded apply/adjoint (parallel/symdual_sharded.py) must reproduce
ops/symdual.py exactly on every DISTINCT-index slot (repeated-index
entries of the per-degree tensors are documented don't-cares)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import Mesh

from manisdp.ops import symdual
from manisdp.parallel.symdual_sharded import ShardedSymDualOp


def _mesh(ndev):
    devs = jax.devices()
    if len(devs) < ndev:
        pytest.skip(f"needs {ndev} devices")
    return Mesh(np.array(devs[:ndev]), ("model",))


def _distinct_masks(q):
    ii = np.arange(q)
    m2 = ii[:, None] != ii[None, :]
    i3, j3, k3 = np.meshgrid(ii, ii, ii, indexing="ij")
    m3 = (i3 != j3) & (i3 != k3) & (j3 != k3)
    i4, j4, k4, l4 = np.meshgrid(ii, ii, ii, ii, indexing="ij")
    m4 = ((i4 != j4) & (i4 != k4) & (i4 != l4)
          & (j4 != k4) & (j4 != l4) & (k4 != l4))
    return m2, m3, m4


@pytest.mark.parametrize("q,ndev", [(8, 8), (12, 4), (6, 2)])
def test_apply_matches_unsharded(q, ndev):
    mesh = _mesh(ndev)
    n = 2 + q + q * q
    rng = np.random.default_rng(0)
    M = rng.standard_normal((n, n))
    M = M + M.T

    ref = symdual._apply_tensor(jnp.asarray(M), q)
    op = ShardedSymDualOp(q, mesh)
    got = op.apply(*op.split_matrix(M))

    m2, m3, m4 = _distinct_masks(q)
    np.testing.assert_allclose(float(got[0]), float(ref[0]), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(got[1]), np.asarray(ref[1]),
                               rtol=1e-12, atol=1e-12)
    for g, r, m in [(got[2], ref[2], m2), (got[3], ref[3], m3),
                    (got[4], ref[4], m4)]:
        np.testing.assert_allclose(np.asarray(g)[m], np.asarray(r)[m],
                                   rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("q,ndev", [(8, 8), (12, 4)])
def test_adjoint_matches_unsharded(q, ndev):
    mesh = _mesh(ndev)
    rng = np.random.default_rng(1)
    y0 = float(rng.standard_normal())
    y1 = rng.standard_normal(q)
    Y2 = rng.standard_normal((q, q))
    Y3 = rng.standard_normal((q, q, q))
    Y4 = rng.standard_normal((q, q, q, q))

    ref = symdual._adjoint_tensor(jnp.float64(y0), jnp.asarray(y1),
                                  jnp.asarray(Y2), jnp.asarray(Y3),
                                  jnp.asarray(Y4), q)
    op = ShardedSymDualOp(q, mesh)
    from jax.sharding import NamedSharding, PartitionSpec as P
    Y4s = jax.device_put(jnp.asarray(Y4),
                         NamedSharding(mesh, P("model")))
    top, rowsQ = op.adjoint((jnp.float64(y0), jnp.asarray(y1),
                             jnp.asarray(Y2), jnp.asarray(Y3), Y4s))
    got = op.merge_matrix(top, rowsQ)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-12,
                               atol=1e-12)


def test_roundtrip_matches_unsharded():
    """apply -> scale -> adjoint chain (one AL cost step's operator
    work) sharded vs unsharded, on distinct-slot-projected input."""
    q, ndev = 8, 8
    mesh = _mesh(ndev)
    n = 2 + q + q * q
    rng = np.random.default_rng(2)
    M = rng.standard_normal((n, n))
    M = M + M.T

    ref_y = symdual._apply_tensor(jnp.asarray(M), q)
    ref_W = symdual._adjoint_tensor(*ref_y, q)

    op = ShardedSymDualOp(q, mesh)
    y = op.apply(*op.split_matrix(M))
    got_W = op.merge_matrix(*op.adjoint(y))
    np.testing.assert_allclose(got_W, np.asarray(ref_W), rtol=1e-11,
                               atol=1e-11)
