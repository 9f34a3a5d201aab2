"""Native C++ kernels vs the JAX masked-product geometry: the two
independent implementations must agree (the C++ side mirrors the
reference MEX surface with corrected semantics, SURVEY §2.3)."""

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")

from manisdp.manifolds.product import MaskedProduct
from manisdp.native import MultiblockKernels, apply_factored_cpu, \
    mat_symmetrize

PS = [2, 3, 4]
NS = [5, 6, 4]
NOB = 2
RNG = np.random.RandomState(0)


def random_blocks():
    blocks = []
    for b, (p, n) in enumerate(zip(PS, NS)):
        B = RNG.randn(p, n)
        if b < NOB:
            B = B / np.sqrt((B ** 2).sum(axis=0))
        blocks.append(B)
    return blocks


def to_flat(blocks, p_max):
    """Embed blocks into the flat (p_max, N) masked layout."""
    N = sum(NS)
    Y = np.zeros((p_max, N))
    off = 0
    for b, B in enumerate(blocks):
        Y[:B.shape[0], off:off + B.shape[1]] = B
        off += B.shape[1]
    return Y


def col_mask():
    N = sum(NS)
    mask = np.zeros(N)
    off = 0
    for b, n in enumerate(NS):
        if b < NOB:
            mask[off:off + n] = 1.0
        off += n
    return mask


def test_proj_retr_match_masked_product():
    p_max = max(PS)
    K = MultiblockKernels(PS, NS, NOB)
    M = MaskedProduct(col_mask())

    x = random_blocks()
    u = [RNG.randn(p, n) for p, n in zip(PS, NS)]

    proj_cpp = K.proj(x, u)
    retr_cpp = K.retr(x, u)

    Yx = jnp.asarray(to_flat(x, p_max))
    Yu = jnp.asarray(to_flat(u, p_max))
    proj_jax = np.asarray(M.proj(Yx, Yu))
    retr_jax = np.asarray(M.retr(Yx, Yu))

    off = 0
    for b, (p, n) in enumerate(zip(PS, NS)):
        np.testing.assert_allclose(proj_cpp[b], proj_jax[:p, off:off + n],
                                   atol=1e-13)
        np.testing.assert_allclose(retr_cpp[b], retr_jax[:p, off:off + n],
                                   atol=1e-13)
        off += n


def test_inner_lincomb_zerovec():
    K = MultiblockKernels(PS, NS, NOB)
    u = [RNG.randn(p, n) for p, n in zip(PS, NS)]
    v = [RNG.randn(p, n) for p, n in zip(PS, NS)]
    ref = sum(float(np.sum(a * b)) for a, b in zip(u, v))
    np.testing.assert_allclose(K.inner(u, v), ref, rtol=1e-14)

    lc = K.lincomb(2.0, u, -0.5, v)
    for a, b, c in zip(u, v, lc):
        np.testing.assert_allclose(c, 2.0 * a - 0.5 * b, atol=1e-14)

    for z, (p, n) in zip(K.zerovec(), zip(PS, NS)):
        assert z.shape == (p, n)
        assert np.all(z == 0)


def test_rand_on_manifold():
    K = MultiblockKernels(PS, NS, NOB)
    blocks = K.rand(seed=42)
    for b, B in enumerate(blocks):
        assert B.shape == (PS[b], NS[b])
        if b < NOB:
            np.testing.assert_allclose((B ** 2).sum(axis=0), 1.0,
                                       atol=1e-12)


def test_mat_symmetrize():
    n = 5
    A = RNG.randn(n, n)
    out = mat_symmetrize(A.flatten(order="F"), n)
    np.testing.assert_allclose(out, 0.5 * (A + A.T), atol=1e-14)


def test_apply_factored_cpu_matches_device():
    import scipy.sparse as sp
    from manisdp.ops.sparse import ConstraintOp

    n, m, p = 9, 7, 3
    rs = np.random.RandomState(2)
    rows, cols, vals = [], [], []
    for k in range(m):
        for _ in range(3):
            i, j = rs.randint(0, n, 2)
            v = rs.randn()
            rows += [i + j * n, j + i * n]
            cols += [k, k]
            vals += [v, v]
    At = sp.coo_matrix((vals, (rows, cols)), shape=(n * n, m)).tocsc()
    b = rs.randn(m)
    c = rs.randn(n * n)
    c = (c.reshape(n, n) + c.reshape(n, n).T).flatten()
    op = ConstraintOp.build(At, b, c, n)

    Y = rs.randn(p, n)
    U = rs.randn(p, n)
    dev = np.asarray(op.apply_factored(jnp.asarray(Y), jnp.asarray(U)))

    # CSR by constraint row from the op's sorted entries
    kk = np.asarray(op.k)
    indptr = np.searchsorted(kk, np.arange(m + 1))
    w = apply_factored_cpu(indptr, np.asarray(op.i), np.asarray(op.j),
                           np.asarray(op.v), Y, U)
    np.testing.assert_allclose(w, dev, atol=1e-12)
