"""Clique-sparse SNL moment relaxation (snl_mom_sparse.m equivalent).

Oracles:
  - single clique over all variables == the dense order-2 relaxation
    (same SDP, so the optima must agree) on a NOISY instance whose
    optimum is nonzero;
  - planted noiseless instance: the objective is a sum of squares
    vanishing at the true positions, so the relaxation value is exactly
    0 — solved through the multiblock driver on a 2-clique chain.
"""

import numpy as np
import pytest

from manisdp import solve_sdp
from manisdp.frontends.lasserre import dense_sdp_relax
from manisdp.frontends.snl import (snl_mom_sparse, snl_problem,
                                   sparse_moment_relax)
from manisdp.solvers.multiblock import solve_multiblock


def test_single_clique_matches_dense():
    obj, nvar, _ = snl_problem(2, seed=3, noise=0.05)
    dense = dense_sdp_relax(obj, [], nvar, kappa=2)
    sparse1 = sparse_moment_relax(obj, nvar, [list(range(nvar))])
    assert int(np.atleast_1d(sparse1.K.s)[0]) == dense.K.s

    maxc = max(np.abs(dense.c).max(), 1.0)
    kw = dict(verbose=False, sigma0=1.0, sigma_min=1e1, theta=1e-3,
              tr_maxiter=8, line_search=False, alpha=0.01, tol=1e-6,
              max_outer=300)
    r_d = solve_sdp(dense.At, dense.b, dense.c / maxc, dense.K.s, **kw)
    r_s = solve_sdp(sparse1.At, sparse1.b, sparse1.c / maxc,
                    int(np.atleast_1d(sparse1.K.s)[0]), **kw)
    assert r_d.eta < 1e-6 and r_s.eta < 1e-6
    np.testing.assert_allclose(r_s.obj, r_d.obj, rtol=1e-4, atol=1e-6)
    # noisy instance: optimum strictly positive
    assert r_d.obj * maxc > 1e-6


def test_two_clique_chain_multiblock():
    """seed 14: in-range pairs (0,1), (1,2) + anchors on sensor 2 ->
    chain cliques {s0,s1}, {s1,s2} cover the objective; planted
    noiseless optimum is exactly 0."""
    obj, nvar, _ = snl_problem(3, seed=14)
    cl1, cl2 = [0, 1, 3, 4], [1, 2, 4, 5]
    data = sparse_moment_relax(obj, nvar, [cl1, cl2])
    ns = [int(x) for x in np.atleast_1d(data.K.s)]
    maxc = np.abs(data.c).max()
    res = solve_multiblock(data.At, data.b, data.c / maxc, ns=ns, nob=0,
                           verbose=False, sigma0=1.0, sigma_min=1e1,
                           theta=1e-3, tr_maxiter=8, alpha=0.01,
                           tol=1e-6, max_outer=300)
    assert res.eta < 1e-6
    assert abs(res.obj * maxc) < 1e-5     # planted optimum = 0


def test_snl_mom_sparse_front_door():
    data = snl_mom_sparse(2, seed=3)
    n = int(np.atleast_1d(data.K.s)[0])
    maxc = np.abs(data.c).max()
    res = solve_sdp(data.At, data.b, data.c / maxc, n, verbose=False,
                    sigma0=1.0, sigma_min=1e1, theta=1e-3, tr_maxiter=8,
                    line_search=False, alpha=0.01, tol=1e-4,
                    max_outer=300)
    assert res.eta < 1e-4
    # noiseless planted optimum is 0; at tol=1e-4 (the reference's SNL
    # tolerance, Sensor_Network_Localization.m:37) the solved value
    # sits within the unscaled duality-gap slack of it
    assert abs(res.obj * maxc) < 5e-3
