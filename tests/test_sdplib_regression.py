"""SDPLIB certified-optimum regression (data/sdplib/README:26-120).

The reference treats the SDPLIB table of certified optima as its
ground-truth oracle (SURVEY §4.4).  Round 3 widens the table from 3 to
13 instances across five problem classes — Lovász theta (theta1-3),
MaxCut (mcp*), graph partitioning (gpp*) and truss topology (truss*,
which carry an LP cone + multiple small PSD blocks and exercise the
K.l folding in solvers/dispatch.py that the REFERENCE drivers cannot
run at all) — with theta1 certified at the full 1e-8 contract.

Note fromsdpa negates the objective (max -> min), so our optimum is
the negative of the README value.
"""

import os

import numpy as np
import pytest

from manisdp import solve_sedumi
from manisdp.frontends.sdpa import read_sdpa

SDPLIB = os.environ.get("MANISDP_SDPLIB_DIR",
                        "/root/reference/data/sdplib")

pytestmark = pytest.mark.skipif(
    not os.path.isdir(SDPLIB),
    reason=f"SDPLIB data not found at {SDPLIB} "
           "(set MANISDP_SDPLIB_DIR)")

# per-class recipes (CPU-sane budgets; measured in rounds 3-4)
THETA = dict(tr_maxiter=8, tr_maxinner=40)
THETA_BIG = dict(tr_maxiter=10, tr_maxinner=60, sigma0=1e2,
                 tau1=1e-3, tau2=1e-2)
TRUSS = dict(tr_maxiter=20, tr_maxinner=80, sigma0=1.0, sigma_min=1e-1,
             tau1=1e-2, tau2=1e-1)
ARCH = dict(tr_maxiter=30, tr_maxinner=150, sigma0=1.0, sigma_min=1e-1,
            tau1=1e-2, tau2=1e-1, max_outer=300)
CTRL = dict(tr_maxiter=30, tr_maxinner=200, sigma0=1e1, sigma_min=1e0,
            tau1=1e-3, tau2=1e-2, max_outer=400)
SS30 = dict(tr_maxiter=20, tr_maxinner=80, sigma0=1.0, sigma_min=1e-1,
            tau1=1e-2, tau2=1e-1, max_outer=600)

# (name, certified optimum from data/sdplib/README, tol, eta bound,
#  obj rtol, kw).  The mcp* rows run the full 1e-8 contract.  gpp100's eta
# floors at ~4.5e-8 (sigma-controller limit cycle at the boundary —
# the certified optimum is matched to 1e-8 relative); arch0/control1
# exercise the K.l folding dispatch path on classes the REFERENCE
# drivers cannot run at all, at the accuracy the AL families reach
# without per-instance tuning.
TABLE = [
    ("theta1", 2.300000e+01, 1e-8, 1e-8, 1e-4,
     dict(THETA, max_outer=600)),
    ("theta2", 3.287917e+01, 1e-6, 1e-5, 1e-4, THETA_BIG),
    ("theta3", 4.216698e+01, 1e-6, 1e-5, 1e-4, THETA_BIG),
    ("mcp100", 2.261574e+02, 1e-8, 1e-8, 1e-6, {}),
    ("mcp124-1", 1.419905e+02, 1e-8, 1e-8, 1e-6, {}),
    ("mcp250-1", 3.172643e+02, 1e-8, 1e-8, 1e-6, {}),
    ("mcp500-1", 5.981485e+02, 1e-8, 1e-8, 1e-6, dict(max_outer=500)),
    ("gpp100", -4.49435e+01, 1e-7, 1e-7, 1e-6, dict(max_outer=700)),
    ("gpp124-1", -7.3431e+00, 1e-6, 1e-5, 1e-4, {}),
    ("gpp250-1", -1.5445e+01, 1e-6, 1e-5, 1e-4, {}),
    ("truss1", -8.999996e+00, 1e-6, 1e-5, 1e-4, TRUSS),
    ("truss3", -9.109996e+00, 1e-6, 1e-5, 1e-4, TRUSS),
    ("truss4", -9.009996e+00, 1e-6, 1e-5, 1e-4, TRUSS),
    # arch0 floors at eta ~6e-4 / obj rel ~1.4e-3 (round-5 sweep,
    # tighter tau or larger sigma both blow the
    # gap; analysis in NOTES.md) — bounds tightened 5-10x from r4
    ("arch0", 5.66517e-01, 1e-8, 1e-3, 2e-3, ARCH),
    # control1 tightened 100x in round 5 (escape gating on dinf <= tol
    # killed the junk-escape limit cycle; the residual ~1e-5 floor of
    # the K.l+PSD mixed class is analyzed in NOTES.md round-5 section)
    ("control1", 1.778463e+01, 1e-8, 5e-5, 5e-5, CTRL),
]

# heavyweight certified rows (run with `pytest -m slow`): excluded from
# run_tests.sh to keep the suite under ~12 min on the 2-vCPU host
SLOW_TABLE = [
    # full 1e-8 contract: converged at iter 500, 609 s on the 2-vCPU
    # host, optimum matched to 7 digits
    ("maxG11", 6.291648e+02, 1e-8, 1e-8, 1e-6, dict(max_outer=700)),
    # eta floors at ~1.0e-6 (measured at 300 and 600 outers alike);
    # optimum matched to 5e-7 relative
    ("ss30", 2.02395e+01, 1e-8, 2e-6, 1e-5, SS30),
]


@pytest.mark.slow
@pytest.mark.parametrize("name,certified,tol,eta_max,obj_rtol,kw",
                         SLOW_TABLE, ids=[t[0] for t in SLOW_TABLE])
def test_sdplib_certified_optimum_slow(name, certified, tol, eta_max,
                                       obj_rtol, kw):
    test_sdplib_certified_optimum(name, certified, tol, eta_max,
                                  obj_rtol, kw)


@pytest.mark.parametrize("name,certified,tol,eta_max,obj_rtol,kw",
                         TABLE, ids=[t[0] for t in TABLE])
def test_sdplib_certified_optimum(name, certified, tol, eta_max,
                                  obj_rtol, kw):
    d = read_sdpa(f"{SDPLIB}/{name}.dat-s")
    kw = dict(kw)
    res = solve_sedumi(d, verbose=False, tol=tol,
                       max_outer=kw.pop("max_outer", 300), **kw)
    if eta_max <= 1e-7:
        assert res.status == 0, f"{name}: eta={res.eta:.2e}"
    assert res.eta < eta_max, f"{name}: eta={res.eta:.2e}"
    rel = abs(-res.obj - certified) / (1.0 + abs(certified))
    assert rel < obj_rtol, f"{name}: obj={-res.obj}, certified={certified}"
