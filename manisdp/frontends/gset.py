"""MaxCut cost matrices: Gset files and seeded Gset-class generators.

Gset format: first line "nv ne", then ne lines "i j w" (1-based).
MaxCut SDP cost is C = -L/4 (example/example_maxcut.m:10-11), with L
the graph Laplacian (basicfunction/Laplacian.m).

The generators rebuild the two Gset families the reference benchmarks
from a seed, for machines without the Gset files: the same class, not
the same instance.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def laplacian(W) -> sp.csr_matrix:
    """Graph Laplacian diag(W 1) - W of a symmetric weight matrix."""
    W = sp.csr_matrix(W)
    deg = np.asarray(W.sum(axis=1)).ravel()
    return (sp.diags(deg) - W).tocsr()


def _symmetric(i, j, w, n) -> sp.csr_matrix:
    return sp.coo_matrix((np.concatenate([w, w]),
                          (np.concatenate([i, j]), np.concatenate([j, i]))),
                         shape=(n, n)).tocsr()


def load_gset_laplacian(path: str) -> sp.csr_matrix:
    """Sparse graph Laplacian from a Gset edge-list file."""
    with open(path) as f:
        first = f.readline().split()
        nv, ne = int(first[0]), int(first[1])
        edges = np.loadtxt(f, ndmin=2)[:ne]
    i = edges[:, 0].astype(np.int64) - 1
    j = edges[:, 1].astype(np.int64) - 1
    return laplacian(_symmetric(i, j, edges[:, 2].astype(np.float64), nv))


def maxcut_cost(path: str) -> sp.csr_matrix:
    """C = -L/4 for the MaxCut SDP."""
    return (-0.25) * load_gset_laplacian(path)


def random_graph(n: int, density: float, seed: int = 0) -> sp.csr_matrix:
    """Weight matrix of an Erdos-Renyi graph with unit weights: each of
    the n(n-1)/2 edges present with probability ``density`` (Gset
    G1-G5 class: n = 800, density 0.06)."""
    rng = np.random.default_rng(seed)
    i, j = np.triu_indices(n, k=1)
    keep = rng.random(i.shape[0]) < density
    return _symmetric(i[keep], j[keep], np.ones(int(keep.sum())), n)


def toroidal_grid(rows: int, cols: int, seed: int = 0) -> sp.csr_matrix:
    """Weight matrix of a rows x cols 2-D toroidal grid with random
    +-1 edge weights (Gset G62-G81 class; G67 is 100 x 100)."""
    rng = np.random.default_rng(seed)
    v = np.arange(rows * cols).reshape(rows, cols)
    i = np.concatenate([v.ravel(), v.ravel()])
    j = np.concatenate([np.roll(v, -1, axis=1).ravel(),
                        np.roll(v, -1, axis=0).ravel()])
    w = rng.choice([-1.0, 1.0], size=i.shape[0])
    return _symmetric(i, j, w, rows * cols)


def maxcut_cost_from_weights(W) -> sp.csr_matrix:
    """C = -L/4 for a weight matrix from the generators above."""
    return (-0.25) * laplacian(W)
