"""Benchmark workload generators (the reference's example/ problem
constructions as library functions).

Each returns SeDuMi-style data ready for the matching driver:
  - matrix_completion:  trace-min completion (example_matrixcompletion.m)
  - lovasz_theta:       random-graph theta problem (example_theta.m)
  - hamming_theta:      theta of Hamming graphs (generate_hamming.m)
  - bqp_instance:       random binary quadratic program (example_bqp.m)
  (STLS lives in frontends/stls.py: the kron-lifted nearest
   rank-deficient Hankel relaxation of example_stls.m)
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import scipy.sparse as sp

from .sedumi import Cone, SedumiData


def matrix_completion(p: int, q: int, rank: int, m_samples: int,
                      seed: int = 3) -> Tuple[SedumiData, np.ndarray]:
    """Trace-minimization matrix completion (example_matrixcompletion.m:9-46).

    min tr(X) s.t. X = [[W1, Z], [Z', W2]] >= 0, Z_jk = M_jk on Omega,
    with X of size n = p + q; constraints set symmetric off-block
    entries to the observed values (b_i = 2*M_jk).
    Returns (data, M_true).
    """
    rs = np.random.RandomState(seed)
    n = p + q
    M = rs.randn(p, rank) @ rs.randn(rank, q)
    omega = np.unique(rs.randint(0, p * q, size=m_samples))
    m = len(omega)
    jj = omega // q          # row in M (0-based)
    kk = omega % q           # col in M
    b = 2.0 * M[jj, kk]
    # X[j, p+k] and X[p+k, j] entries (column-major vec)
    rows = np.concatenate([jj * n + (kk + p), (kk + p) * n + jj])
    cols = np.concatenate([np.arange(m), np.arange(m)])
    vals = np.ones(2 * m)
    At = sp.coo_matrix((vals, (rows, cols)), shape=(n * n, m)).tocsc()
    c = np.eye(n).flatten(order="F")
    return SedumiData(At=At, b=b, c=c, K=Cone(s=n)), M


def bqp_instance(q: int, seed: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """(Q, e) of min x'Qx + e'x over {-1,1}^q with standard-normal
    entries (example/example_bqp.m draws its instances this way).
    Feed bqpsos / bqpmom or the one-call BQP solvers."""
    rng = np.random.default_rng(seed)
    Q = rng.standard_normal((q, q))
    Q = (Q + Q.T) / 2.0
    e = rng.standard_normal(q)
    return Q, e


def lovasz_theta(n: int, m_edges: int, seed: int = 1) -> SedumiData:
    """Random-graph Lovasz theta SDP (example_theta.m:2-44):
    max <J, X> s.t. X_ij = 0 for edges, tr(X) = 1  (SeDuMi min form
    with C = -ones).  The trace row is LAST (column m+1), matching the
    reference layout."""
    rs = np.random.RandomState(seed)
    om = rs.randint(0, n, size=(m_edges, 2))
    om = om[om[:, 0] < om[:, 1]]
    om = np.unique(om, axis=0)
    m = len(om)
    rows = np.concatenate([om[:, 0] * n + om[:, 1],
                           om[:, 1] * n + om[:, 0],
                           np.arange(n) * n + np.arange(n)])
    cols = np.concatenate([np.arange(m), np.arange(m),
                           np.full(n, m)])
    vals = np.concatenate([np.ones(2 * m), np.ones(n)])
    At = sp.coo_matrix((vals, (rows, cols)), shape=(n * n, m + 1)).tocsc()
    b = np.zeros(m + 1)
    b[m] = 1.0
    c = -np.ones(n * n)
    return SedumiData(At=At, b=b, c=c, K=Cone(s=n))


def hamming_theta(d: int, dists: Sequence[int]) -> SedumiData:
    """Theta function of the Hamming graph H(d, {dists})
    (generate_hamming.m): vertices = {0,1}^d, edges between words at
    Hamming distance in ``dists``; theta SDP as in lovasz_theta."""
    n = 2 ** d
    words = np.arange(n)
    edges = []
    dset = set(int(x) for x in dists)
    for delta in range(1, n):
        if bin(delta).count("1") in dset:
            i = words
            j = words ^ delta
            keep = i < j
            edges.append(np.stack([i[keep], j[keep]], axis=1))
    om = np.unique(np.concatenate(edges, axis=0), axis=0)
    m = len(om)
    rows = np.concatenate([om[:, 0] * n + om[:, 1],
                           om[:, 1] * n + om[:, 0],
                           np.arange(n) * n + np.arange(n)])
    cols = np.concatenate([np.arange(m), np.arange(m), np.full(n, m)])
    vals = np.concatenate([np.ones(2 * m), np.ones(n)])
    At = sp.coo_matrix((vals, (rows, cols)), shape=(n * n, m + 1)).tocsc()
    b = np.zeros(m + 1)
    b[m] = 1.0
    c = -np.ones(n * n)
    return SedumiData(At=At, b=b, c=c, K=Cone(s=n))
