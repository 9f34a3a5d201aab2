"""SymDualOp (gather-free expanded-basis SOS-dual operator) validation.

Anchor: the EXPANDED sparse data from bqpsos_expanded_sparse fed through
the generic DualOp is the ground truth; SymDualOp must reproduce its
cost/grad/hess/stats exactly (same math, tensor representation).  The
expanded formulation itself is validated end-to-end against the
original-basis solver (same optimum on instances where the order-2
relaxation is tight, which includes every reference BQP instance)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from manisdp.ops.dualops import DualOp
from manisdp.ops.symdual import (SymDualOp, _num_classes,
                                 bqpsos_expanded_sparse,
                                 expanded_masks)

Q_SEED = 7


def _rand_bqp(q, seed=Q_SEED):
    rng = np.random.default_rng(seed)
    Q = rng.standard_normal((q, q))
    Q = (Q + Q.T) / 2
    e = rng.standard_normal(q)
    return Q, e


def _canon_slots(q):
    """Flat indices of canonical (sorted-index) slots and their masks."""
    slots, masks = [0], [np.uint64(0)]
    o1, o2, o3 = 1 + q, 1 + q + q * q, 1 + q + q * q + q ** 3
    for a in range(q):
        slots.append(1 + a)
        masks.append(np.uint64(1 << a))
    for a in range(q):
        for b in range(a + 1, q):
            slots.append(o1 + a * q + b)
            masks.append(np.uint64((1 << a) ^ (1 << b)))
    for a in range(q):
        for b in range(a + 1, q):
            for c in range(b + 1, q):
                slots.append(o2 + a * q * q + b * q + c)
                masks.append(np.uint64((1 << a) ^ (1 << b) ^ (1 << c)))
    for a in range(q):
        for b in range(a + 1, q):
            for c in range(b + 1, q):
                for d in range(c + 1, q):
                    slots.append(o3 + a * q ** 3 + b * q * q + c * q + d)
                    masks.append(np.uint64(
                        (1 << a) ^ (1 << b) ^ (1 << c) ^ (1 << d)))
    return np.array(slots), np.array(masks, dtype=np.uint64)


def _row_of_mask(q):
    """monomial mask -> sparse row index map (matching the generator)."""
    from manisdp.frontends.monomials import monomial_basis
    sp4 = monomial_basis(q, 4, max_power=1)
    pow2 = (1 << np.arange(q, dtype=np.uint64))
    masks4 = (sp4.astype(np.uint64).T * pow2).sum(axis=1)
    order4 = np.argsort(masks4, kind="stable")
    sorted4 = masks4[order4]
    return lambda mk: order4[np.searchsorted(sorted4, mk)]


def test_class_sizes_match_sparse():
    q = 5
    Q, e = _rand_bqp(q)
    from math import comb
    A_full, b, c, nn, f, dAAt = bqpsos_expanded_sparse(Q, e, q)
    op = SymDualOp.build_bqpsos(Q, e, q)
    slots, masks = _canon_slots(q)
    rows = _row_of_mask(q)(masks)
    degs = np.repeat(np.arange(5), [1, q, comb(q, 2), comb(q, 3),
                                    comb(q, 4)])
    got = 1.0 / np.asarray(op.idAAt)[degs]
    np.testing.assert_allclose(got, dAAt[rows], rtol=0, atol=0)
    assert _num_classes(q) == len(dAAt)


def test_apply_matches_sparse():
    q = 5
    Q, e = _rand_bqp(q)
    A_full, b, c, nn, f, dAAt = bqpsos_expanded_sparse(Q, e, q)
    sop = DualOp.build(A_full, b, c, nn, f, dAAt)
    top = SymDualOp.build_bqpsos(Q, e, q)
    rng = np.random.default_rng(3)
    M = jnp.asarray(rng.standard_normal((nn, nn)))
    ys = np.asarray(sop.apply(M))
    yt = np.asarray(top.apply_flat(M))
    slots, masks = _canon_slots(q)
    rows = _row_of_mask(q)(masks)
    np.testing.assert_allclose(yt[slots], ys[rows], rtol=1e-12, atol=1e-12)


def test_adjoint_matches_sparse_and_ignores_dontcare():
    q = 5
    Q, e = _rand_bqp(q)
    A_full, b, c, nn, f, dAAt = bqpsos_expanded_sparse(Q, e, q)
    sop = DualOp.build(A_full, b, c, nn, f, dAAt)
    top = SymDualOp.build_bqpsos(Q, e, q)
    rng = np.random.default_rng(4)
    yclass = rng.standard_normal(len(dAAt))
    # flat-dense y: class value at every permutation slot, JUNK at
    # repeated-index slots (they must never be read)
    slots, masks = _canon_slots(q)
    rows = _row_of_mask(q)(masks)
    em = expanded_masks(q)
    pair_masks = np.bitwise_xor.outer(em, em)   # class mask of every entry
    # per-degree flat layout masks: build flat y by mapping every slot's
    # monomial mask through the class values
    from manisdp.ops.symdual import _dontcare_mask
    o1 = 1 + q
    flat_masks = np.zeros(top.m, dtype=np.uint64)
    flat_masks[0] = 0
    flat_masks[1:o1] = 1 << np.arange(q, dtype=np.uint64)
    ii, jj = np.meshgrid(np.arange(q), np.arange(q), indexing="ij")
    m2 = (1 << ii.astype(np.uint64)) ^ (1 << jj.astype(np.uint64))
    flat_masks[o1:o1 + q * q] = m2.reshape(-1)
    i3, j3, k3 = np.meshgrid(*([np.arange(q)] * 3), indexing="ij")
    m3 = ((1 << i3.astype(np.uint64)) ^ (1 << j3.astype(np.uint64))
          ^ (1 << k3.astype(np.uint64)))
    flat_masks[o1 + q * q:o1 + q * q + q ** 3] = m3.reshape(-1)
    i4, j4, k4, l4 = np.meshgrid(*([np.arange(q)] * 4), indexing="ij")
    m4 = ((1 << i4.astype(np.uint64)) ^ (1 << j4.astype(np.uint64))
          ^ (1 << k4.astype(np.uint64)) ^ (1 << l4.astype(np.uint64)))
    flat_masks[o1 + q * q + q ** 3:] = m4.reshape(-1)
    yflat = yclass[_row_of_mask(q)(flat_masks)]
    dc = _dontcare_mask(q)
    yflat[dc] = 1e9                      # poison the don't-care slots
    Ws = np.asarray(sop.adjoint(jnp.asarray(yclass)))
    Wt = np.asarray(top.adjoint(jnp.asarray(yflat)))
    np.testing.assert_allclose(Wt, Ws, rtol=1e-12, atol=1e-12)


def test_cost_grad_hess_stats_match_sparse():
    import dataclasses
    import scipy.sparse as sp
    q = 5
    Q, e = _rand_bqp(q)
    A_full, b, c, nn, f, dAAt = bqpsos_expanded_sparse(Q, e, q)
    maxb = np.max(np.abs(b))
    # drop the free column: SymDualOp has no free block (redundant on
    # the expanded basis, see build_bqpsos)
    sop = DualOp.build(sp.csr_matrix(A_full)[:, 1:], b / maxb, c[1:],
                       nn, 0, dAAt)
    top0 = SymDualOp.build_bqpsos(Q, e, q)
    top = dataclasses.replace(top0, b=top0.b / maxb, bA=top0.bA / maxb)
    from manisdp.solvers.dual_al import (DUAL_VARIANTS, _make_problem,
                                         _make_stats)
    variant = DUAL_VARIANTS["dual_unitdiag"]
    problem, _ = _make_problem(variant, None)
    stats = _make_stats(variant, None)
    rng = np.random.default_rng(5)
    p = 4
    Y = rng.standard_normal((p, nn))
    Y = jnp.asarray(Y / np.linalg.norm(Y, axis=0, keepdims=True))
    U = jnp.asarray(rng.standard_normal((p, nn)))
    Xm = rng.standard_normal((nn, nn))
    Xm = jnp.asarray((Xm + Xm.T) / 2)
    w = jnp.zeros(0)
    sigma = jnp.float64(0.37)

    outs = {}
    for name, op in (("sparse", sop), ("tensor", top)):
        params = dict(op=op, Xm=Xm, w=w, sigma=sigma)
        fval, aux = problem.cost(Y, params)
        g, gaux = problem.grad(Y, params, aux)
        h = problem.hess(Y, U, params, aux, gaux)
        st = stats(Y, op, Xm, w, sigma, jnp.float64(1.0))
        outs[name] = (np.asarray(fval), np.asarray(g), np.asarray(h),
                      [np.asarray(x) for k, x in enumerate(st)
                       if k != 1])          # skip y (rep-dependent)
    np.testing.assert_allclose(outs["tensor"][0], outs["sparse"][0],
                               rtol=1e-10)
    np.testing.assert_allclose(outs["tensor"][1], outs["sparse"][1],
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(outs["tensor"][2], outs["sparse"][2],
                               rtol=1e-9, atol=1e-9)
    for a, bb in zip(outs["tensor"][3], outs["sparse"][3]):
        np.testing.assert_allclose(a, bb, rtol=1e-9, atol=1e-9)



def test_expanded_solve_matches_original_optimum():
    import dataclasses
    from manisdp.frontends.sos import assemble_bqpsos
    from manisdp.solvers.dual_unitdiag import solve_dual_unitdiag
    q = 8
    Q, e = _rand_bqp(q, seed=11)
    A, b, c, mb, f, dAAt = assemble_bqpsos(Q, e, q)
    maxb = np.max(np.abs(b))
    res_orig = solve_dual_unitdiag(A, b / maxb, c, mb, f=f, dAAt=dAAt,
                                   line_search=True, verbose=False,
                                   tol=1e-8)
    top = SymDualOp.build_bqpsos(Q, e, q)
    top = dataclasses.replace(top, b=top.b / maxb, bA=top.bA / maxb)
    res_exp = solve_dual_unitdiag(top, None, None, top.n,
                                  line_search=True, verbose=False,
                                  tol=1e-8, p0=4)
    assert res_orig.status == 0
    assert res_exp.status == 0
    np.testing.assert_allclose(res_exp.obj, res_orig.obj, rtol=1e-8)
