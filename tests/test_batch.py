"""Batched-instance driver: B MaxCut SDPs solved concurrently must each
match the single-instance driver's certified optimum."""

import numpy as np

from manisdp import solve_maxcut_batch, solve_maxcut_unitdiag


def random_sym_cost(n, seed):
    rs = np.random.RandomState(seed)
    B = rs.randn(n, n)
    C = 0.5 * (B + B.T)
    np.fill_diagonal(C, 0.0)
    return C


def test_batch_matches_single():
    n, B = 24, 4
    Cs = [random_sym_cost(n, seed) for seed in range(B)]
    batch = solve_maxcut_batch(Cs, tol=1e-7, verbose=False, max_outer=40)
    assert len(batch) == B
    for b, C in enumerate(Cs):
        single = solve_maxcut_unitdiag(C, tol=1e-7, verbose=False)
        assert batch[b].status == 0, f"instance {b} not optimal"
        assert batch[b].dinf < 1e-7
        # same certified optimum (independent runs, same problem)
        assert abs(batch[b].obj - single.obj) < 1e-5 * (1 + abs(single.obj))
        # unit diagonal feasibility
        assert np.allclose(np.diag(batch[b].X), 1.0, atol=1e-9)


def test_batch_on_batch_mesh():
    import jax
    from jax.sharding import Mesh

    n, B = 16, 8
    Cs = [random_sym_cost(n, seed) for seed in range(B)]
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("batch",))
    batch = solve_maxcut_batch(Cs, mesh=mesh, tol=1e-6, verbose=False,
                               max_outer=40)
    assert all(r.status == 0 for r in batch)
    assert all(r.dinf < 1e-6 for r in batch)


def random_sparse_cost(n, seed, density=0.25):
    import scipy.sparse as sp
    rs = np.random.RandomState(seed)
    W = sp.random(n, n, density=density, random_state=rs)
    W = W + W.T
    L = sp.diags(np.asarray(W.sum(axis=1)).ravel()) - W
    return (-L / 4).tocoo()


def test_batch_ragged_sizes_and_sparse():
    """Mixed instance sizes bucket + pad, and
    scipy-sparse costs batch through the padded-SymCOO kernels; every
    instance matches its single-instance certified optimum."""
    Cs = [random_sym_cost(20, 0),            # dense, n=20
          random_sparse_cost(26, 1),         # sparse, n=26
          random_sym_cost(33, 2),            # dense, n=33 (2nd bucket)
          random_sparse_cost(20, 3)]         # sparse, n=20
    batch = solve_maxcut_batch(Cs, tol=1e-7, verbose=False, max_outer=60,
                               n_bucket=32)
    assert len(batch) == len(Cs)
    for b, C in enumerate(Cs):
        single = solve_maxcut_unitdiag(C, tol=1e-7, verbose=False)
        assert batch[b].status == 0, f"instance {b} not optimal"
        assert batch[b].dinf < 1e-7
        assert abs(batch[b].obj - single.obj) < \
            1e-5 * (1 + abs(single.obj))
        n = C.shape[0]
        assert batch[b].X.shape == (n, n)    # padding stripped
        assert np.allclose(np.diag(batch[b].X), 1.0, atol=1e-9)


def test_batch_forced_sparse_kernels():
    """Force the sparse-COO batched path (dense_cost_max_n=0) and check
    it certifies the same optima as the dense batched path."""
    Cs = [random_sparse_cost(18, 7), random_sparse_cost(18, 8)]
    dense = solve_maxcut_batch(Cs, tol=1e-7, verbose=False, max_outer=60)
    sparse = solve_maxcut_batch(Cs, tol=1e-7, verbose=False, max_outer=60,
                                dense_cost_max_n=0, dense_cost_nnz_factor=0)
    for rd, rs_ in zip(dense, sparse):
        assert rs_.status == 0 and rs_.dinf < 1e-7
        assert abs(rd.obj - rs_.obj) < 1e-5 * (1 + abs(rd.obj))
