"""Lovasz-theta workload regression (example_theta.m config, scaled
down).  This is the workload where the forced-accept escape line search
caused a dinf limit cycle; the extended backtracking (common.py
make_line_search) must let it converge to the 1e-6 KKT oracle."""

import numpy as np
import scipy.sparse as sp

from manisdp import solve_unittrace
from manisdp.frontends.workloads import lovasz_theta


def test_theta_converges():
    n = 60
    data = lovasz_theta(n, 10 * n, seed=1)
    At = sp.csc_matrix(data.At)
    m = At.shape[1] - 1          # trace row -> handled by the manifold
    res = solve_unittrace(At[:, :m], data.b[:m], data.c, data.K.s,
                          tol=1e-6, sigma0=1e5, sigma_max=1e8,
                          line_search=True, verbose=False, max_outer=200)
    assert res.status == 0, f"theta stalled: eta={res.eta:.2e}"
    assert res.eta < 1e-6
    # external oracles computed from the raw X:
    np.testing.assert_allclose(np.trace(res.X), 1.0, atol=1e-7)
    # (1) edge-constraint feasibility: X_ij = 0 on every edge
    ei, ej = _edges(At[:, :m], n)
    assert np.abs(res.X[ei, ej]).max() < 1e-6
    # (2) theta >= alpha >= greedy independent set (Lovasz sandwich)
    theta = -res.obj
    adj = np.zeros((n, n), dtype=bool)
    adj[ei, ej] = True
    adj |= adj.T
    indep = []
    for v in np.argsort(adj.sum(axis=1)):
        if not any(adj[v, u] for u in indep):
            indep.append(v)
    assert theta >= len(indep) - 1e-6


def _edges(At, n):
    """Recover the edge list from the constraint columns (each edge
    constraint touches exactly the (i, j)/(j, i) pair)."""
    import scipy.sparse as sp
    coo = sp.coo_matrix(At).tocsc()
    ei, ej = [], []
    for k in range(coo.shape[1]):
        rows = coo[:, k].nonzero()[0]
        i, j = rows[0] // n, rows[0] % n
        ei.append(min(i, j))
        ej.append(max(i, j))
    return np.asarray(ei), np.asarray(ej)


def test_theta_known_values():
    """Exact closed-form oracles: theta(C5) = sqrt(5) (Lovasz 1979) and
    theta(Petersen) = 4 (Kneser graph K(5,2))."""
    # 5-cycle
    c5_edges = [(0, 1), (1, 2), (2, 3), (3, 4), (0, 4)]
    res = _solve_edge_graph(5, c5_edges)
    np.testing.assert_allclose(-res.obj, np.sqrt(5.0), rtol=1e-7)

    # Petersen graph: vertices = 2-subsets of {0..4}, edges = disjoint
    from itertools import combinations
    verts = list(combinations(range(5), 2))
    pe = [(a, b) for a in range(10) for b in range(a + 1, 10)
          if not set(verts[a]) & set(verts[b])]
    res = _solve_edge_graph(10, pe)
    np.testing.assert_allclose(-res.obj, 4.0, rtol=1e-7)


def _solve_edge_graph(n, edges):
    import scipy.sparse as sp
    m = len(edges)
    ei = np.array([e[0] for e in edges])
    ej = np.array([e[1] for e in edges])
    rows = np.concatenate([ei * n + ej, ej * n + ei])
    cols = np.concatenate([np.arange(m), np.arange(m)])
    At = sp.coo_matrix((np.ones(2 * m), (rows, cols)),
                       shape=(n * n, m)).tocsc()
    # default unittrace settings (the 1e5 sigma0 of example_theta.m is
    # tuned for n=1000 random graphs and stalls on tiny graphs)
    res = solve_unittrace(At, np.zeros(m), -np.ones(n * n), n,
                          tol=1e-8, verbose=False, max_outer=500)
    assert res.status == 0 and res.eta < 1e-8
    return res
