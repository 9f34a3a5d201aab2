"""Bring-up support: seeded instance generators, chip_smoke.py's host
KKT checkers (against the independent IPM in utils/ipm.py), its refusal
to run without a GPU, and the compile-cache placement."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp

from manisdp import solve_maxcut_unitdiag
from manisdp.frontends.gset import (laplacian, maxcut_cost_from_weights,
                                    random_graph, toroidal_grid)
from manisdp.frontends.workloads import bqp_instance, matrix_completion
from manisdp.utils.ipm import solve_sdp_ipm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402


# -- generators ------------------------------------------------------------

def test_random_graph_class():
    W = random_graph(800, 0.06, seed=1)
    assert W.shape == (800, 800)
    assert (W != W.T).nnz == 0 and W.diagonal().sum() == 0
    assert set(np.unique(W.data)) == {1.0}
    ne = W.nnz // 2
    assert abs(ne / (800 * 799 / 2) - 0.06) < 0.003      # G1: 19176 edges
    assert (random_graph(800, 0.06, seed=1) != W).nnz == 0
    assert (random_graph(800, 0.06, seed=2) != W).nnz > 0


def test_toroidal_grid_class():
    W = toroidal_grid(100, 100, seed=1)
    assert W.shape == (10000, 10000)
    assert (W != W.T).nnz == 0 and W.diagonal().sum() == 0
    assert set(np.unique(W.data)) == {-1.0, 1.0}
    deg = np.diff(W.indptr)
    assert np.all(deg == 4)                                # 4-regular torus
    assert W.nnz // 2 == 20000                             # G67: 20000 edges
    assert (toroidal_grid(100, 100, seed=1) != W).nnz == 0
    assert (toroidal_grid(100, 100, seed=2) != W).nnz > 0


@pytest.mark.parametrize("make", [lambda: random_graph(30, 0.3, 0),
                                  lambda: toroidal_grid(4, 5, 0)])
def test_maxcut_cost_is_quarter_laplacian(make):
    W = make()
    C = maxcut_cost_from_weights(W)
    L = laplacian(W)
    np.testing.assert_allclose(C.toarray(), -0.25 * L.toarray())
    np.testing.assert_allclose(L @ np.ones(W.shape[0]), 0.0, atol=1e-12)


def test_bqp_instance_deterministic():
    Q, e = bqp_instance(60, seed=1)
    assert Q.shape == (60, 60) and e.shape == (60,)
    np.testing.assert_array_equal(Q, Q.T)
    Q2, e2 = bqp_instance(60, seed=1)
    np.testing.assert_array_equal(Q, Q2)
    np.testing.assert_array_equal(e, e2)
    assert not np.allclose(bqp_instance(60, seed=2)[0], Q)


# -- host KKT checkers against the IPM -------------------------------------

def test_maxcut_kkt_checker_vs_ipm():
    W = random_graph(14, 0.4, seed=3)
    C = maxcut_cost_from_weights(W)
    n = C.shape[0]
    rows = np.arange(n) * n + np.arange(n)
    At = sp.coo_matrix((np.ones(n), (rows, np.arange(n))),
                       shape=(n * n, n)).tocsc()
    ipm = solve_sdp_ipm(At, np.ones(n), C.toarray().ravel(order="F"), n)
    res = solve_maxcut_unitdiag(C, verbose=False)
    kkt = chip_smoke.maxcut_kkt(C, res.Y)
    assert kkt["diag_err"] <= 1e-10
    assert kkt["dinf"] <= 1e-7
    np.testing.assert_allclose(kkt["obj"], ipm.obj, rtol=1e-7)
    # a non-optimal feasible point is flagged
    Y = np.random.default_rng(0).standard_normal((3, n))
    Y /= np.linalg.norm(Y, axis=0)
    assert chip_smoke.maxcut_kkt(C, Y)["dinf"] > 1e-3
    # the sparse (eigsh) branch agrees with the dense one
    big = maxcut_cost_from_weights(toroidal_grid(70, 70, seed=1))
    Yb = np.random.default_rng(1).standard_normal((4, big.shape[0]))
    Yb /= np.linalg.norm(Yb, axis=0)
    d_sp = chip_smoke.maxcut_kkt(big, Yb)
    d_de = chip_smoke.maxcut_kkt(big.toarray(), Yb)
    np.testing.assert_allclose(d_sp["lam_min"], d_de["lam_min"],
                               rtol=1e-9)


def test_sdp_kkt_checker_vs_ipm():
    data, _ = matrix_completion(4, 5, rank=1, m_samples=12, seed=3)
    n = data.K.s
    ipm = solve_sdp_ipm(data.At, data.b, data.c, n, tol=1e-10)
    w, V = np.linalg.eigh(ipm.X)
    Y = (V * np.sqrt(np.maximum(w, 0.0))).T
    kkt = chip_smoke.sdp_kkt(data.At, data.b, data.c, n, Y, ipm.y)
    assert kkt["pinf"] <= 1e-7 and kkt["dinf"] <= 1e-7
    assert kkt["gap"] <= 1e-7
    np.testing.assert_allclose(kkt["obj"], ipm.obj, rtol=1e-7)
    y_bad = ipm.y + 1.0
    assert chip_smoke.sdp_kkt(data.At, data.b, data.c, n, Y,
                              y_bad)["dinf"] > 1e-3


# -- refusal without a GPU ---------------------------------------------------

def _run(args, cwd, env_extra=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.update(env_extra or {})
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_smoke_refuses_cpu():
    r = _run([os.path.join(REPO, "chip_smoke.py")], REPO)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU" in r.stderr


def test_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(["chip_smoke.py"], str(tmp_path),
             {"PYTHONPATH": "", "JAX_COMPILATION_CACHE_DIR": str(tmp_path)})
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


# -- compile cache -----------------------------------------------------------

_CACHE_PROBE = ("import json, jax, manisdp; "
                "print(json.dumps(jax.config.jax_compilation_cache_dir))")


def test_compile_cache_default_inside_checkout():
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, "-c", _CACHE_PROBE], cwd=REPO,
                       env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout.strip().splitlines()[-1]) == \
        os.path.join(REPO, ".jax_cache")


def test_compile_cache_honours_env(tmp_path):
    r = _run(["-c", _CACHE_PROBE], REPO,
             {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)})
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout.strip().splitlines()[-1]) == str(tmp_path)


# -- on the card (skip here; chip_smoke.py runs the same checks) ------------

@pytest.mark.gpu
def test_device_eigh_f64_on_card(gpu_device):
    out, ok = chip_smoke.check_eigh()
    assert ok, out


@pytest.mark.gpu
def test_symdual_vs_bqpsos_on_card(gpu_device):
    out, ok = chip_smoke.check_symdual(60)
    assert ok, out
