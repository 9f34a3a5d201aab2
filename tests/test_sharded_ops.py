"""Sharded sparse-operator equivalence: every protocol op and the full
AL driver must match the single-device path bit-for-bit (modulo fp
reduction order) on the virtual 8-device CPU mesh.

This covers the reference's AL hot products (A*x, At*w, A'A vec(Y'U) of
src/primal/ManiSDP_unitdiag.m:152-171) in their mesh-sharded form.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
from jax.sharding import PartitionSpec as P

from manisdp.ops.sparse import ConstraintOp
from manisdp.parallel.mesh import make_mesh
from manisdp.parallel.sharded_ops import ShardedConstraintOp

needs8 = pytest.mark.skipif(len(jax.devices()) < 8,
                            reason="needs 8 devices")


def _random_problem(n=24, m=30, seed=3, density=0.15):
    """Random symmetric constraint set + cost in SeDuMi layout."""
    rs = np.random.RandomState(seed)
    rows, cols, vals, ks = [], [], [], []
    for k in range(m):
        B = sp.random(n, n, density=density, random_state=rs).toarray()
        A = 0.5 * (B + B.T)
        i, j = np.nonzero(A)
        rows.append(i * 1)
        cols.append(j * 1)
        vals.append(A[i, j])
        ks.append(np.full(i.shape, k))
    lin = np.concatenate(rows) + n * np.concatenate(cols)
    At = sp.coo_matrix(
        (np.concatenate(vals), (lin, np.concatenate(ks))),
        shape=(n * n, m)).tocsc()
    Cb = rs.randn(n, n)
    C = 0.5 * (Cb + Cb.T)
    b = rs.randn(m)
    return At, b, C.reshape(-1, order="F"), n, m


def _factor(n, p, seed=0):
    rs = np.random.RandomState(seed)
    Y = rs.randn(p, n)
    return jnp.asarray(Y / np.sqrt((Y ** 2).sum(axis=0)))


@needs8
def test_sharded_ops_match_single():
    At, b, c, n, m = _random_problem()
    op = ConstraintOp.build(At, b, c, n)
    mesh = make_mesh(8, "model")
    sop_h = ShardedConstraintOp.build(op, 8)
    sop = jax.device_put(sop_h, sop_h.shardings(mesh))
    specs = sop_h.specs()
    nnzP = op.pat.nnz

    Y = _factor(n, 4, 0)
    U = _factor(n, 4, 1) - Y
    w = jnp.asarray(np.random.RandomState(2).randn(m))
    V = jnp.asarray(np.random.RandomState(4).randn(n, 3))

    def run(fn, in_specs, out_specs):
        return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                                     out_specs=out_specs, check_vma=False))

    # forward A(vec(Y'U)): psum over shards
    fwd = run(lambda o, a, u: o.apply_factored(a, u),
              (specs, P(), P()), P())
    np.testing.assert_allclose(np.asarray(fwd(sop, Y, U)),
                               np.asarray(op.apply_factored(Y, U)),
                               rtol=1e-12, atol=1e-12)

    # adjoint mat(A'w) on P: sharded output, padding-stripped
    adj = run(lambda o, w_: o.adjoint_on_pattern(w_),
              (specs, P()), P("model"))
    np.testing.assert_allclose(np.asarray(adj(sop, w))[:nnzP],
                               np.asarray(op.adjoint_on_pattern(w)),
                               rtol=1e-12, atol=1e-12)

    # matmat Y @ mat(es) with es = c + sigma A'w on P
    def mm(o, y_, w_):
        es = o.es_vals(w_, 2.5)
        return o.matmat_pattern(y_, es)
    mm_s = run(mm, (specs, P(), P()), P())
    np.testing.assert_allclose(np.asarray(mm_s(sop, Y, w)),
                               np.asarray(mm(op, Y, w)),
                               rtol=1e-12, atol=1e-12)

    # certificate matvec mat(sv) @ V and column sums
    def mv(o, v_, w_):
        sv = o.s_vals(w_)
        return o.matvec_pattern(v_, sv)
    mv_s = run(mv, (specs, P(), P()), P())
    np.testing.assert_allclose(np.asarray(mv_s(sop, V, w)),
                               np.asarray(mv(op, V, w)),
                               rtol=1e-12, atol=1e-12)

    def cs(o, y_, u_):
        e = o.pattern_pair_dots(y_, u_)
        return o.colsum_pattern(o.c_pattern * e)
    cs_s = run(cs, (specs, P(), P()), P())
    np.testing.assert_allclose(np.asarray(cs_s(sop, Y, U)),
                               np.asarray(cs(op, Y, U)),
                               rtol=1e-12, atol=1e-12)

    # dot_pattern <c, e>
    dp = run(lambda o, y_: o.dot_pattern(o.c_pattern,
                                         o.pattern_pair_dots(y_)),
             (specs, P()), P())
    e_full = op.pattern_pair_dots(Y)
    np.testing.assert_allclose(float(dp(sop, Y)),
                               float(op.dot_pattern(op.c_pattern, e_full)),
                               rtol=1e-12)


@needs8
def test_sharded_al_driver_matches_single():
    """Full unitdiag AL driver, sharded vs single: identical history."""
    from manisdp import solve_unitdiag

    n = 16
    rows = np.arange(n) * n + np.arange(n)
    At = sp.coo_matrix((np.ones(n), (rows, np.arange(n))),
                       shape=(n * n, n)).tocsc()
    b = np.ones(n)
    rs = np.random.RandomState(11)
    Cb = rs.randn(n, n)
    C = 0.5 * (Cb + Cb.T)
    np.fill_diagonal(C, 0.0)
    c = C.reshape(-1, order="F")

    kw = dict(verbose=False, max_outer=6, seed=5)
    res1 = solve_unitdiag(At, b, c, n, **kw)
    mesh = make_mesh(8, "model")
    res8 = solve_unitdiag(At, b, c, n, mesh=mesh, **kw)

    assert res8.iterations == res1.iterations
    np.testing.assert_allclose(res8.obj, res1.obj, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(res8.X, res1.X, rtol=1e-7, atol=1e-8)
    for h8, h1 in zip(res8.history, res1.history):
        np.testing.assert_allclose(h8["pinf"], h1["pinf"],
                                   rtol=1e-7, atol=1e-10)


@needs8
def test_sharded_lobpcg_certificate_path():
    """Force the matrix-free LOBPCG certificate (the large-n path) under
    shard_map: results must match the single-device LOBPCG solve."""
    from manisdp import solve_unitdiag

    n = 96          # lobpcg needs 5 * block < n
    rows = np.arange(n) * n + np.arange(n)
    At = sp.coo_matrix((np.ones(n), (rows, np.arange(n))),
                       shape=(n * n, n)).tocsc()
    rs = np.random.RandomState(3)
    Cb = rs.randn(n, n)
    C = 0.5 * (Cb + Cb.T)
    np.fill_diagonal(C, 0.0)
    c = C.reshape(-1, order="F")

    kw = dict(verbose=False, max_outer=25, eig_method="lobpcg", seed=2)
    res1 = solve_unitdiag(At, np.ones(n), c, n, **kw)
    mesh = make_mesh(8, "model")
    res8 = solve_unitdiag(At, np.ones(n), c, n, mesh=mesh, **kw)
    np.testing.assert_allclose(res8.obj, res1.obj, rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(res8.dinf, res1.dinf, rtol=1e-5, atol=1e-10)


@needs8
def test_sharded_general_sdpa_converges():
    """The Euclidean (general) variant also runs sharded end-to-end."""
    from manisdp import solve_sdp

    n, m = 12, 8
    rs = np.random.RandomState(0)
    # random feasible SDP: X0 PSD, b = A(X0)
    W = rs.randn(n, 3)
    X0 = W @ W.T
    rows, cols, vals, ks = [], [], [], []
    for k in range(m):
        B = rs.randn(n, n)
        A = 0.5 * (B + B.T)
        i, j = np.nonzero(A)
        rows.append(i)
        cols.append(j)
        vals.append(A[i, j])
        ks.append(np.full(i.shape, k))
    lin = np.concatenate(rows) + n * np.concatenate(cols)
    At = sp.coo_matrix((np.concatenate(vals), (lin, np.concatenate(ks))),
                       shape=(n * n, m)).tocsc()
    As = [np.asarray(At[:, k].todense()).reshape(n, n, order="F")
          for k in range(m)]
    b = np.array([np.sum(A * X0) for A in As])
    C = np.eye(n).reshape(-1, order="F")     # trace minimization

    mesh = make_mesh(8, "model")
    res = solve_sdp(At, b, C, n, mesh=mesh, verbose=False, max_outer=60)
    res1 = solve_sdp(At, b, C, n, verbose=False, max_outer=60)
    np.testing.assert_allclose(res.obj, res1.obj, rtol=1e-6, atol=1e-6)
    assert res.eta < 1e-6
