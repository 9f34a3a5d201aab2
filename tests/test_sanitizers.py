"""Sanitizer-style checks (SURVEY §5 race/sanitizer row):
NaN-cleanliness of one outer iteration per driver family
under jax.debug_nans, and bitwise determinism of full solves.

The reference is single-threaded MATLAB (nothing to race); the JAX
rebuild's equivalents are jit purity + deterministic reductions, which
these tests pin down.
"""

import jax
import numpy as np
import pytest
import scipy.sparse as sp

from manisdp import (solve_dual_unitdiag, solve_maxcut_unitdiag,
                     solve_sdp, solve_unitdiag)
from manisdp.frontends.moments import bqpmom
from manisdp.frontends.sos import assemble_bqpsos
from manisdp.frontends.workloads import matrix_completion


def _bqp(n=6, seed=0):
    rs = np.random.RandomState(seed)
    Q = rs.randn(n, n)
    Q = 0.5 * (Q + Q.T)
    return Q, rs.randn(n)


def _maxcut_C(n=20, seed=1):
    rs = np.random.RandomState(seed)
    W = sp.random(n, n, density=0.3, random_state=rs)
    W = W + W.T
    L = sp.diags(np.asarray(W.sum(axis=1)).ravel()) - W
    return (-L / 4).tocoo()


@pytest.mark.parametrize("run", [
    pytest.param(lambda: solve_maxcut_unitdiag(
        _maxcut_C(), verbose=False, max_outer=1), id="maxcut"),
    pytest.param(lambda: (lambda d: solve_unitdiag(
        d.At, d.b, d.c, d.K.s, verbose=False, max_outer=1))(
            bqpmom(6, *_bqp())), id="primal_al"),
    pytest.param(lambda: (lambda t: solve_dual_unitdiag(
        t[0], t[1] / np.max(np.abs(t[1])), t[2], t[3], f=t[4], dAAt=t[5],
        verbose=False, max_outer=1))(
            assemble_bqpsos(*_bqp(), 6)), id="dual_al"),
    pytest.param(lambda: (lambda d: solve_sdp(
        d[0].At, d[0].b, d[0].c, d[0].K.s, verbose=False, max_outer=1))(
            matrix_completion(15, 15, rank=2, m_samples=150, seed=3)),
        id="general_entrywise"),
])
def test_one_iteration_nan_clean(run):
    """jax.debug_nans raises on ANY NaN materialized inside jitted
    code; one outer iteration of each family must be NaN-free."""
    with jax.debug_nans(True):
        res = run()
    assert np.isfinite(res.obj)


def test_full_solve_deterministic():
    """Same seed -> bit-identical trajectory (deterministic reductions;
    no hidden RNG state outside the threaded PRNG keys)."""
    Q, e = _bqp(6, 3)
    data = bqpmom(6, Q, e)

    def solve():
        return solve_unitdiag(data.At, data.b, data.c, data.K.s,
                              verbose=False)

    r1, r2 = solve(), solve()
    assert r1.obj == r2.obj
    assert r1.iterations == r2.iterations
    for h1, h2 in zip(r1.history, r2.history):
        assert h1["obj"] == h2["obj"]
        assert h1["gradnorm"] == h2["gradnorm"]
        assert h1["pinf"] == h2["pinf"]


def test_maxcut_deterministic():
    C = _maxcut_C(24, seed=2)
    r1 = solve_maxcut_unitdiag(C, verbose=False)
    r2 = solve_maxcut_unitdiag(C, verbose=False)
    assert r1.obj == r2.obj
    assert [h["dinf"] for h in r1.history] == \
        [h["dinf"] for h in r2.history]
