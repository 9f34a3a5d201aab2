"""Factored sparse operators vs dense references."""

import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

from manisdp.ops.sparse import ConstraintOp, SymCOO

RNG = np.random.default_rng(0)


def random_sym_sparse(n, density=0.2):
    M = sp.random(n, n, density=density, random_state=np.random.RandomState(0))
    M = M + M.T
    return M.tocsr()


def test_symcoo_matmat_and_quads():
    n, p = 12, 3
    M = random_sym_sparse(n)
    C = SymCOO.from_scipy(M)
    Y = RNG.standard_normal((p, n))
    Md = M.toarray()

    np.testing.assert_allclose(np.asarray(C.matmat(jnp.asarray(Y))),
                               Y @ Md, atol=1e-12)
    X = Y.T @ Y
    np.testing.assert_allclose(np.asarray(C.quad_cols(jnp.asarray(Y))),
                               np.sum(Md * X, axis=0), atol=1e-12)
    np.testing.assert_allclose(float(C.quad_form(jnp.asarray(Y))),
                               np.sum(Md * X), atol=1e-12)
    V = RNG.standard_normal((n, 4))
    np.testing.assert_allclose(np.asarray(C.matvec_block(jnp.asarray(V))),
                               Md @ V, atol=1e-12)
    np.testing.assert_allclose(np.asarray(C.to_dense()), Md, atol=1e-14)


def _random_sedumi(n, m, seed=0):
    """Random symmetric sparse constraint set in SeDuMi layout."""
    rs = np.random.RandomState(seed)
    rows, cols, vals = [], [], []
    for k in range(m):
        nent = rs.randint(1, 4)
        for _ in range(nent):
            i, j = rs.randint(0, n, size=2)
            v = rs.standard_normal()
            # symmetric entries
            rows += [i + j * n, j + i * n]
            cols += [k, k]
            vals += [v, v]
    At = sp.coo_matrix((vals, (rows, cols)), shape=(n * n, m)).tocsc()
    b = rs.standard_normal(m)
    Cd = rs.standard_normal((n, n))
    Cd = Cd + Cd.T
    Cs = sp.coo_matrix(Cd)
    c = np.asarray(Cs.todense()).flatten(order="F")
    return At, b, c, Cd


def test_constraint_op_forward_and_adjoint():
    n, m, p = 8, 10, 3
    At, b, c, Cd = _random_sedumi(n, m)
    op = ConstraintOp.build(At, b, c, n)
    A = At.T.tocsr()

    Y = RNG.standard_normal((p, n))
    X = Y.T @ Y
    np.testing.assert_allclose(np.asarray(op.apply_factored(jnp.asarray(Y))),
                               A @ X.flatten(order="F"), atol=1e-12)

    U = RNG.standard_normal((p, n))
    np.testing.assert_allclose(
        np.asarray(op.apply_factored(jnp.asarray(Y), jnp.asarray(U))),
        A @ (Y.T @ U).flatten(order="F"), atol=1e-12)

    # adjoint on pattern: mat(A'w) + c reconstruction
    w = RNG.standard_normal(m)
    dense_adj = (A.T @ w).reshape(n, n, order="F")
    np.testing.assert_allclose(
        np.asarray(op.pattern_dense(op.adjoint_on_pattern(jnp.asarray(w)))),
        dense_adj, atol=1e-12)

    sigma = 1.7
    es = op.es_vals(jnp.asarray(w), sigma)
    np.testing.assert_allclose(np.asarray(op.pattern_dense(es)),
                               Cd + sigma * dense_adj, atol=1e-12)

    # Y @ mat(es) through the pattern
    eS_dense = Cd + sigma * dense_adj
    np.testing.assert_allclose(
        np.asarray(op.pat.matmat_vals(jnp.asarray(Y), es)),
        Y @ eS_dense, atol=1e-12)

    # s_vals: c - A'y
    y = RNG.standard_normal(m)
    np.testing.assert_allclose(
        np.asarray(op.pattern_dense(op.s_vals(jnp.asarray(y)))),
        Cd - (A.T @ y).reshape(n, n, order="F"), atol=1e-12)


def test_constraint_op_quad_cols_via_pattern():
    n, m, p = 6, 5, 2
    At, b, c, Cd = _random_sedumi(n, m, seed=3)
    op = ConstraintOp.build(At, b, c, n)
    Y = RNG.standard_normal((p, n))
    w = RNG.standard_normal(m)
    es = op.es_vals(jnp.asarray(w), 0.5)
    eS_dense = np.asarray(op.pattern_dense(es))
    X = Y.T @ Y
    z = np.asarray(op.pat.quad_cols(jnp.asarray(Y), vals=es)) \
        if hasattr(op.pat, "quad_cols_vals") else None
    # direct: use matmat_vals then colsum
    z2 = np.sum(np.asarray(op.pat.matmat_vals(jnp.asarray(Y), es)) *
                Y, axis=0)
    np.testing.assert_allclose(z2, np.sum(eS_dense * X, axis=0), atol=1e-12)
