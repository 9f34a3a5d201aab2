"""Quartic minimization over the sphere, moment + SOS routes
(reference example/example_qsphere.m, example/dual/example_qsphere_dual.m)."""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.abspath(
    _os.path.join(_os.path.dirname(__file__), "..")))

import sys
import time

import numpy as np

from manisdp import solve_dual_sdp, solve_sdp
from manisdp.frontends.moments import qsmom
from manisdp.frontends.monomials import monomial_basis
from manisdp.frontends.sos import qssos


def main():
    d = int(sys.argv[1]) if len(sys.argv) > 1 else 10
    rs = np.random.RandomState(1)
    coe = rs.randn(monomial_basis(d, 4).shape[1])

    data = qsmom(d, coe)
    t0 = time.time()
    rp = solve_sdp(data.At, data.b, data.c, data.K.s,
                   theta=1e-2, tau1=0.02)
    print(f"primal (moment): optimum = {rp.obj:0.8f}, "
          f"eta = {rp.eta:0.1e}, time = {time.time() - t0:0.2f}s")

    A, b, c, mb, f, dAAt = qssos(d, coe)
    maxb = np.max(np.abs(b))
    t0 = time.time()
    rd = solve_dual_sdp(A, b / maxb, c, mb, f=f, dAAt=dAAt,
                        theta=1e-1, tau2=0.5)
    print(f"dual (SOS):      optimum = {rd.obj * maxb:0.8f}, "
          f"eta = {rd.eta:0.1e}, time = {time.time() - t0:0.2f}s")


if __name__ == "__main__":
    main()
