"""Row-for-row exactness of ops/symmom.SymMomOp against the sparse
bqpmom frontend (frontends/moments.py), plus operator adjointness."""

from math import comb

import numpy as np
import pytest

from manisdp.frontends.moments import bqpmom
from manisdp.frontends.monomials import monomial_basis
from manisdp.ops.symmom import SymMomOp


def _colex_pairs(q):
    iu, ju = np.triu_indices(q, k=1)
    order = np.lexsort((iu, ju))
    return list(zip(iu[order], ju[order]))


def _flat_slot_map(q):
    """moments.bqpmom row index l -> SymMomOp flat slot index."""
    q2, q3 = q * q, q ** 3
    bD1 = 1
    bD2 = bD1 + q
    bSv = bD2 + q2
    bSp = bSv + q2
    bE2 = bSp + q3
    bE4 = bE2 + q2
    bE6 = bE4 + q3
    pairs = _colex_pairs(q)
    idx = [0]
    for a in range(q):
        idx.append(bD1 + a)
    for (u, v) in pairs:
        idx += [bD2 + u * q + v, bD2 + v * q + u]
    for k in range(q):
        for b in range(q):
            if b != k:
                idx.append(bSv + k * q + b)
        for (u, v) in pairs:
            if k != u and k != v:
                idx.append(bSp + k * q2 + u * q + v)
    # EQ rows follow the label (class) order of monomial_basis(q, 4,
    # max_power=2, drop_all_even=True); only classes with >= 2 pairs
    # emit rows (moments.py:88-98)
    spm = monomial_basis(q, 4, max_power=2, drop_all_even=True)
    for t in range(spm.shape[1]):
        exp = spm[:, t]
        supp1 = np.nonzero(exp == 1)[0]
        supp2 = np.nonzero(exp == 2)[0]
        if len(supp2):
            continue                      # {k:2,...} classes: one pair
        if len(supp1) == 2:
            a, b = supp1
            idx.append(bE2 + a * q + b)
        elif len(supp1) == 3:
            a, b, c = supp1
            idx += [bE4 + a * q2 + b * q + c, bE4 + b * q2 + a * q + c]
        elif len(supp1) == 4:
            a, b, c, d = supp1
            idx += [bE6 + ((a * q + b) * q + c) * q + d,
                    bE6 + ((b * q + a) * q + c) * q + d]
    return np.asarray(idx)


def _expand_values(M_orig, op):
    """Value-duplicate an original symmetric matrix into expanded form."""
    nn = op.n
    dup0 = np.asarray(op.dup0)
    dup1 = np.asarray(op.dup1)
    cols = np.zeros((nn,), dtype=np.int64)
    cols[dup0] = np.arange(op.n_orig)
    cols[dup1] = np.arange(op.n_orig)
    return M_orig[np.ix_(cols, cols)]


@pytest.mark.parametrize("q", [4, 7])
def test_apply_matches_bqpmom_rows(q):
    rng = np.random.default_rng(0)
    Q = rng.standard_normal((q, q))
    Q = (Q + Q.T) / 2
    e = rng.standard_normal(q)
    data = bqpmom(q, Q, e)
    op = SymMomOp.build_bqpmom(Q, e, q)
    mb = 1 + q + comb(q, 2)
    assert op.n_orig == mb
    assert op.m_true == data.b.shape[0]

    M_orig = rng.standard_normal((mb, mb))
    M_orig = (M_orig + M_orig.T) / 2
    M_exp = _expand_values(M_orig, op)

    ref = np.asarray(data.At.T @ M_orig.flatten(order="F"))
    mine = np.asarray(op.apply_from_e(np.asarray(M_exp)))
    smap = _flat_slot_map(q)
    assert smap.shape[0] == data.b.shape[0]
    np.testing.assert_allclose(mine[smap], ref, rtol=1e-12, atol=1e-12)
    # don't-care slots are exactly zero
    mask = np.ones(op.m, dtype=bool)
    mask[smap] = False
    assert np.all(mine[mask] == 0.0)
    # b matches through the same map
    b_mine = np.asarray(op.b)
    np.testing.assert_array_equal(b_mine[smap], data.b)
    assert np.all(b_mine[mask] == 0.0)
    # cost: <C_exp, M_exp> == <c, vec(M_orig)>
    c_ref = float(data.c @ M_orig.flatten(order="F"))
    c_mine = float(np.sum(np.asarray(op.C) * M_exp))
    np.testing.assert_allclose(c_mine, c_ref, rtol=1e-12)


@pytest.mark.parametrize("q", [4, 7])
def test_adjoint_consistency(q):
    rng = np.random.default_rng(1)
    Q = rng.standard_normal((q, q))
    Q = (Q + Q.T) / 2
    op = SymMomOp.build_bqpmom(Q, rng.standard_normal(q), q)
    M = rng.standard_normal((op.n, op.n))
    y = np.asarray(op.apply_from_e(
        np.asarray(rng.standard_normal((op.n, op.n)))))
    lhs = float(np.sum(np.asarray(op.adjoint_on_pattern(y)) * M))
    rhs = float(y @ np.asarray(op.apply_from_e(np.asarray(M))))
    np.testing.assert_allclose(lhs, rhs, rtol=1e-12)


def test_apply_factored_uses_unsymmetrized_gram():
    q = 5
    rng = np.random.default_rng(2)
    op = SymMomOp.build_bqpmom(np.eye(q), np.zeros(q), q)
    Y = rng.standard_normal((3, op.n))
    U = rng.standard_normal((3, op.n))
    w1 = np.asarray(op.apply_factored(np.asarray(Y), np.asarray(U)))
    G = Y.T @ U
    w2 = np.asarray(op.apply_from_e(np.asarray((G + G.T) / 2)))
    np.testing.assert_allclose(w1, w2, rtol=1e-12, atol=1e-12)
