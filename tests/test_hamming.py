"""Hamming-graph theta with closed-form oracles
(reference example/generate_hamming.m).

H(k, {1}) is the hypercube Q_k: bipartite, so theta = alpha = 2^(k-1).
H(k, {k}) is a perfect matching (disjoint edges): theta = 2^(k-1)."""

import numpy as np
import pytest
import scipy.sparse as sp

from manisdp import solve_unittrace
from manisdp.frontends.workloads import hamming_theta


def _solve_theta(data, **kw):
    At = sp.csc_matrix(data.At)
    m = At.shape[1] - 1          # trace row -> the sphere manifold
    res = solve_unittrace(At[:, :m], data.b[:m], data.c, data.K.s,
                          verbose=False, line_search=True, max_outer=300,
                          **kw)
    return res


@pytest.mark.parametrize("k,dists,exact", [
    (3, [1], 4.0),      # Q_3, bipartite -> alpha = 4
    (4, [1], 8.0),      # Q_4 -> 8
    (3, [3], 4.0),      # perfect matching on 8 vertices -> 4
])
def test_hamming_theta_exact(k, dists, exact):
    data = hamming_theta(k, dists)
    res = _solve_theta(data, sigma0=1e3, sigma_max=1e8, tol=1e-8)
    assert res.status == 0, f"theta stalled: eta={res.eta:.2e}"
    np.testing.assert_allclose(-res.obj, exact, rtol=1e-7)
    # feasibility of X on the edge constraints (external check)
    n = data.K.s
    X = res.X
    words = np.arange(n)
    for delta in range(1, n):
        if bin(delta).count("1") in set(dists):
            j = words ^ delta
            assert np.abs(X[words, j]).max() < 1e-6
