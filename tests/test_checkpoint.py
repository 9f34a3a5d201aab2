"""Checkpoint/resume: a solve interrupted at iteration k and resumed
from its snapshot reaches the same optimum as an uninterrupted solve."""

import os
import tempfile

import numpy as np
import scipy.sparse as sp

from manisdp import solve_unitdiag
from manisdp.frontends.moments import bqpmom
from manisdp.utils import load_state, save_state


def test_resume_from_snapshot():
    n = 6
    rs = np.random.RandomState(0)
    Q = rs.randn(n, n)
    Q = 0.5 * (Q + Q.T)
    e = rs.randn(n)
    data = bqpmom(n, Q, e)

    full = solve_unitdiag(data.At, data.b, data.c, data.K.s, verbose=False)
    assert full.status == 0

    # truncated run; SDPResult carries the FINAL penalty so the resume
    # continues the exact trajectory (no hardcoded sigma)
    part = solve_unitdiag(data.At, data.b, data.c, data.K.s, verbose=False,
                          max_outer=5)
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "ckpt.npz")
        save_state(path, Y=part.Y, y=part.y, sigma=part.sigma,
                   iteration=part.iterations)
        st = load_state(path)
        resumed = solve_unitdiag(data.At, data.b, data.c, data.K.s,
                                 verbose=False,
                                 Y0=st["Y"], y0=st["y"],
                                 sigma0=float(st["sigma"]))
    assert resumed.status == 0
    np.testing.assert_allclose(resumed.obj, full.obj, rtol=1e-7)
    assert resumed.iterations <= full.iterations
    # trajectory continuation: the resumed run's first iteration must
    # reproduce the full run's iteration 6 (deterministic small-n path)
    h_full = full.history[part.iterations]
    h_res = resumed.history[0]
    np.testing.assert_allclose(h_res["obj"], h_full["obj"],
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(h_res["pinf"], h_full["pinf"],
                               rtol=1e-8, atol=1e-12)


def test_checkpoint_every_hook():
    """checkpoint_every=k snapshots in-run; the snapshot resumes to the
    same optimum."""
    n = 6
    rs = np.random.RandomState(3)
    Q = rs.randn(n, n)
    Q = 0.5 * (Q + Q.T)
    e = rs.randn(n)
    data = bqpmom(n, Q, e)

    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "auto.npz")
        full = solve_unitdiag(data.At, data.b, data.c, data.K.s,
                              verbose=False, checkpoint_every=3,
                              checkpoint_path=path)
        assert full.status == 0
        assert os.path.exists(path)
        st = load_state(path)
        assert int(st["iteration"]) % 3 == 0
        resumed = solve_unitdiag(data.At, data.b, data.c, data.K.s,
                                 verbose=False, Y0=st["Y"], y0=st["y"],
                                 sigma0=float(st["sigma"]))
    assert resumed.status == 0
    np.testing.assert_allclose(resumed.obj, full.obj, rtol=1e-7)


def test_maxcut_checkpoint_resume():
    """Kill-and-resume for the maxcut driver: the
    checkpoint_every snapshot plus resume= reaches the same optimum."""
    from manisdp import solve_maxcut_unitdiag

    rs = np.random.RandomState(1)
    n = 30
    W = sp.random(n, n, density=0.2, random_state=rs)
    W = W + W.T
    L = sp.diags(np.asarray(W.sum(axis=1)).ravel()) - W
    C = (-L / 4).tocoo()

    with __import__("tempfile").TemporaryDirectory() as td:
        path = os.path.join(td, "mc.npz")
        full = solve_maxcut_unitdiag(C, verbose=False, checkpoint_every=1,
                                     checkpoint_path=path)
        assert full.status == 0
        assert os.path.exists(path)
        resumed = solve_maxcut_unitdiag(C, verbose=False, resume=path)
    assert resumed.status == 0
    np.testing.assert_allclose(resumed.obj, full.obj, rtol=1e-7)
    assert resumed.iterations <= full.iterations


def test_multiblock_checkpoint_resume():
    """Kill-and-resume for the multiblock driver: snapshot carries the
    flat factor, multipliers, sigma AND the per-block rank vector."""
    from manisdp.frontends.sparse_moments import (
        bqpmom_sparse, clique_chain, sparse_objective_basis)
    from manisdp.solvers.multiblock import solve_multiblock

    n, cliques = clique_chain(3, 4)
    nsp = sparse_objective_basis(n, cliques)
    nsp = nsp[:, ~np.all(nsp == 0, axis=0)]
    rs = np.random.RandomState(5)
    coe = rs.randn(nsp.shape[1])
    data = bqpmom_sparse(n, cliques, coe)

    with __import__("tempfile").TemporaryDirectory() as td:
        path = os.path.join(td, "mb.npz")
        full = solve_multiblock(data.At, data.b, data.c, data.K.s,
                                data.K.nob, verbose=False,
                                checkpoint_every=2, checkpoint_path=path)
        assert full.status == 0
        assert os.path.exists(path)
        st = load_state(path)
        assert "extra_ps" in st
        resumed = solve_multiblock(data.At, data.b, data.c, data.K.s,
                                   data.K.nob, verbose=False, resume=path)
    assert resumed.status == 0
    np.testing.assert_allclose(resumed.obj, full.obj, rtol=1e-6)
    assert resumed.iterations <= full.iterations
