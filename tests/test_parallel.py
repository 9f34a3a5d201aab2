"""Sharded execution on the virtual 8-device CPU mesh: the sharded
solve must produce the same result as the single-device solve."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from manisdp.core import TROptions
from manisdp.parallel.mesh import (batched_maxcut_solve, make_mesh,
                                   sharded_maxcut_solve)


def _tiny(n, p, seed):
    rs = np.random.RandomState(seed)
    B = rs.randn(n, n)
    C = 0.5 * (B + B.T)
    np.fill_diagonal(C, 0.0)
    Y = rs.randn(p, n)
    Y = Y / np.sqrt((Y ** 2).sum(axis=0))
    return jnp.asarray(Y), jnp.asarray(C)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_model_sharded_matches_single():
    n, p = 64, 4
    Y, C = _tiny(n, p, 0)
    typdist = float(np.pi * np.sqrt(n))
    opts = TROptions(maxiter=3, maxinner=8, tolgradnorm=1e-10)

    mesh = make_mesh(8, "model")
    solve, shard = sharded_maxcut_solve(mesh, opts)
    rs_ = solve(*shard(Y, C), typdist)

    from manisdp.core import make_trustregions
    from manisdp.parallel.mesh import _maxcut_problem
    single = jax.jit(make_trustregions(_maxcut_problem(), opts))
    r1 = single(Y, C, typdist)

    np.testing.assert_allclose(float(rs_.fx), float(r1.fx), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(rs_.Y), np.asarray(r1.Y),
                               atol=1e-12)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_batch_sharded_instances():
    n, p, B = 32, 4, 8
    mesh = make_mesh(8, "batch")
    opts = TROptions(maxiter=2, maxinner=6, tolgradnorm=1e-10)
    solve, shard = batched_maxcut_solve(mesh, opts)

    Ys, Cs = zip(*[_tiny(n, p, s) for s in range(B)])
    Ys = jnp.stack(Ys)
    Cs = jnp.stack(Cs)
    res = solve(*shard(Ys, Cs), float(np.pi * np.sqrt(n)))
    fx = np.asarray(res.fx)
    assert fx.shape == (B,)
    assert np.all(np.isfinite(fx))
    # instances differ, so objectives should too
    assert len(np.unique(np.round(fx, 6))) > 1


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_host_mesh_layout():
    """make_host_mesh places the process axis outermost and degenerates
    to (1, n) on a single process; the sharded AL solve runs on its
    'model' axis unchanged."""
    from manisdp.parallel.distributed import (init_distributed,
                                              make_batch_host_mesh,
                                              make_host_mesh)

    assert init_distributed() is False          # single process: no-op
    mesh = make_host_mesh()
    assert mesh.axis_names == ("host", "model")
    assert mesh.devices.shape == (1, len(jax.devices()))
    bmesh = make_batch_host_mesh()
    assert bmesh.axis_names == ("batch", "model")

    # simulated 2-host grid from the virtual devices: shape only
    from manisdp.parallel.distributed import _device_grid
    grid = _device_grid(jax.devices(), 2)
    assert grid.shape == (2, 4)

    # the sharded unitdiag driver accepts the model submesh
    import scipy.sparse as sp
    from jax.sharding import Mesh
    from manisdp import solve_unitdiag
    n = 12
    rows = np.arange(n) * n + np.arange(n)
    At = sp.coo_matrix((np.ones(n), (rows, np.arange(n))),
                       shape=(n * n, n)).tocsc()
    rs = np.random.RandomState(0)
    Cb = rs.randn(n, n)
    C = 0.5 * (Cb + Cb.T)
    np.fill_diagonal(C, 0.0)
    model_mesh = Mesh(mesh.devices[0], ("model",))
    res = solve_unitdiag(At, np.ones(n), C.reshape(-1, order="F"), n,
                         mesh=model_mesh, verbose=False, max_outer=4)
    assert np.isfinite(res.obj)

    # make_host_mesh's recommended 2-D (host, model)
    # mesh composes DIRECTLY — sharded over 'model', replicated over
    # 'host' — and reproduces the single-axis submesh solve exactly
    res2d = solve_unitdiag(At, np.ones(n), C.reshape(-1, order="F"), n,
                           mesh=mesh, verbose=False, max_outer=4)
    np.testing.assert_allclose(res2d.obj, res.obj, rtol=1e-9)
    mesh22 = Mesh(_device_grid(jax.devices(), 2), ("host", "model"))
    res22 = solve_unitdiag(At, np.ones(n), C.reshape(-1, order="F"), n,
                           mesh=mesh22, verbose=False, max_outer=4)
    np.testing.assert_allclose(res22.obj, res.obj, rtol=1e-9)
