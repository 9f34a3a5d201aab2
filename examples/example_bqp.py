"""Binary quadratic program via moment (primal) and SOS (dual) routes
(reference example/example_bqp.m + example/dual/example_bqp_dual.m)."""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.abspath(
    _os.path.join(_os.path.dirname(__file__), "..")))

import sys
import time

import numpy as np

from manisdp import solve_dual_unitdiag, solve_unitdiag
from manisdp.frontends.moments import bqpmom
from manisdp.frontends.sos import assemble_bqpsos


def main():
    d = int(sys.argv[1]) if len(sys.argv) > 1 else 30
    rs = np.random.RandomState(1)
    Q = rs.randn(d, d)
    Q = 0.5 * (Q + Q.T)
    e = rs.randn(d)

    data = bqpmom(d, Q, e)
    t0 = time.time()
    res_p = solve_unitdiag(data.At, data.b, data.c, data.K.s)
    print(f"primal (moment): optimum = {res_p.obj:0.8f}, "
          f"eta = {res_p.eta:0.1e}, time = {time.time() - t0:0.2f}s")

    A, b, c, mb, f, dAAt = assemble_bqpsos(Q, e, d)
    maxb = np.max(np.abs(b))
    t0 = time.time()
    res_d = solve_dual_unitdiag(A, b / maxb, c, mb, f=f, dAAt=dAAt,
                                line_search=True)
    print(f"dual (SOS):      optimum = {res_d.obj * maxb:0.8f}, "
          f"eta = {res_d.eta:0.1e}, time = {time.time() - t0:0.2f}s")


if __name__ == "__main__":
    main()
