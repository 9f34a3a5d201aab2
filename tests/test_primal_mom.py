"""End-to-end equivalence of the expanded-tensor primal moment solver
(solvers/primal_mom.solve_bqp_mom) against the sparse-operator path on
small BQP instances: same optimum, full KKT certificate, and the
reference's residual definitions."""

import numpy as np
import pytest

from manisdp.frontends.moments import bqpmom
from manisdp.solvers.primal_mom import solve_bqp_mom
from manisdp.solvers.unitdiag import solve_unitdiag


def _instance(q, seed):
    rng = np.random.default_rng(seed)
    Q = rng.standard_normal((q, q))
    Q = (Q + Q.T) / 2
    e = rng.standard_normal(q)
    return Q, e


@pytest.mark.parametrize("q,seed", [(6, 0), (8, 3)])
def test_matches_sparse_path(q, seed):
    Q, e = _instance(q, seed)
    data = bqpmom(q, Q, e)
    ref = solve_unitdiag(data.At, data.b, data.c, data.K.s,
                         verbose=False, max_outer=200)
    res = solve_bqp_mom(Q, e, q, verbose=False, max_outer=200)
    assert ref.status == 0
    assert res.status == 0
    assert res.eta <= 1e-8
    np.testing.assert_allclose(res.obj, ref.obj, rtol=1e-6, atol=1e-6)


def test_brute_force_optimum():
    q = 6
    Q, e = _instance(q, 11)
    res = solve_bqp_mom(Q, e, q, verbose=False, max_outer=200)
    assert res.status == 0
    # order-2 moment bound <= true binary optimum (tight on most
    # random instances at this size)
    best = np.inf
    for mask in range(1 << q):
        x = np.array([1.0 if mask >> i & 1 else -1.0 for i in range(q)])
        best = min(best, float(x @ Q @ x + e @ x))
    assert res.obj <= best + 1e-6
    assert res.obj >= best - 0.5 * abs(best) - 1e-6
