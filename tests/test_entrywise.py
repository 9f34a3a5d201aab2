"""EntrywiseConstraintOp (matrix-completion class) equivalence tests.

The specialized operator must match the generic ConstraintOp exactly:
same operator algebra entry-for-entry and an end-to-end solver
trajectory that is bit-identical to the dense-carrier path (the
specialization is a representation change, not an algorithm change).
Reference semantics: src/primal/ManiSDP.m:140-165.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from manisdp.frontends.workloads import matrix_completion
from manisdp.ops.sparse import ConstraintOp, EntrywiseConstraintOp


@pytest.fixture(scope="module")
def ops():
    data, _ = matrix_completion(30, 30, rank=3, m_samples=500, seed=3)
    op = ConstraintOp.build(data.At, data.b, data.c, data.K.s)
    ew = EntrywiseConstraintOp.detect(op)
    assert ew is not None
    return op, ew


def test_detect_rejects_non_entrywise():
    from manisdp.frontends.workloads import lovasz_theta
    data = lovasz_theta(20, 60, seed=1)     # trace row has n entries
    op = ConstraintOp.build(data.At, data.b, data.c, data.K.s)
    assert EntrywiseConstraintOp.detect(op) is None


def test_operator_equivalence(ops):
    op, ew = ops
    n = op.n
    rs = np.random.RandomState(0)
    Y = jnp.asarray(rs.randn(4, n))
    U = jnp.asarray(rs.randn(4, n))

    # forward operator on X = Y'Y and on the asymmetric Y'U
    w_g = op.apply_from_e(op.pattern_pair_dots(Y))
    w_e = ew.apply_from_e(ew.pattern_pair_dots(Y))[ew.ki, ew.kj]
    np.testing.assert_allclose(w_g, w_e, rtol=0, atol=1e-12)
    wg2 = op.apply_factored(Y, U)
    we2 = ew.apply_factored(Y, U)[ew.ki, ew.kj]
    np.testing.assert_allclose(wg2, we2, rtol=0, atol=1e-12)

    # residual-space inner products against plain R^m
    y = rs.randn(op.m)
    ye = ew.res_from_mvec(y)
    assert abs(float(ew.dot_res(ye, ye)) - float(y @ y)) < 1e-10
    assert abs(float(ew.dot_res(ew.b, ye))
               - float(np.asarray(op.b) @ y)) < 1e-10
    np.testing.assert_allclose(ew.res_to_mvec(ye), y, atol=0)

    # es_vals / adjoint-of-adjoint (the AL hessian's A'A term)
    sg = op.es_vals(jnp.asarray(y), 2.5)
    Sg = np.zeros((n, n))
    np.add.at(Sg, (np.asarray(op.pat.i), np.asarray(op.pat.j)),
              np.asarray(sg))
    np.testing.assert_allclose(Sg, np.asarray(ew.es_vals(ye, 2.5)),
                               atol=1e-12)
    ayu_g = op.adjoint_on_pattern(wg2)
    Ag = np.zeros((n, n))
    np.add.at(Ag, (np.asarray(op.pat.i), np.asarray(op.pat.j)),
              np.asarray(ayu_g))
    np.testing.assert_allclose(
        Ag, np.asarray(ew.adjoint_on_pattern(ew.apply_factored(Y, U))),
        atol=1e-12)


def test_end_to_end_matches_dense_path():
    from manisdp import solve_sdp
    from manisdp.recipes import recipe
    data, _ = matrix_completion(40, 40, rank=3, m_samples=1200, seed=3)
    _, kw = recipe("mc")
    kw = dict(kw, verbose=False)
    r_dense = solve_sdp(data.At, data.b, data.c, data.K.s,
                        al_op_mode="dense", **kw)
    r_entry = solve_sdp(data.At, data.b, data.c, data.K.s,
                        al_op_mode="entrywise", **kw)
    assert r_entry.status == 0 and r_entry.eta < 1e-8
    assert r_entry.obj == r_dense.obj          # bit-identical trajectory
    np.testing.assert_allclose(r_entry.y, r_dense.y, atol=0)
    assert r_entry.iterations == r_dense.iterations
