"""Sensor-network localization via a dense order-2 moment relaxation
(reference example/Sensor_Network_Localization.m, tol 1e-4).

Small planted instance: sensors in the unit square, squared-distance
measurements to anchors and neighbors; objective is the quartic sum of
residuals, relaxed with the generic Lasserre machinery."""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.abspath(
    _os.path.join(_os.path.dirname(__file__), "..")))

import sys
import time

import numpy as np

from manisdp import solve_sdp
from manisdp.frontends.lasserre import dense_sdp_relax


def main():
    ns = int(sys.argv[1]) if len(sys.argv) > 1 else 3   # sensors (2D)
    rs = np.random.RandomState(0)
    nvar = 2 * ns
    pos = rs.rand(ns, 2)
    anchors = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0], [1.0, 1.0]])

    def var(i, k):
        e = np.zeros(nvar, dtype=np.int64)
        e[2 * i + k] = 1
        return e

    # objective: sum over sensor-anchor pairs of
    #   (||x_i - a||^2 - d^2)^2  expanded as a Poly
    obj = {}

    def add(e, cv):
        key = tuple(e)
        obj[key] = obj.get(key, 0.0) + cv

    def add_sq_residual(i, a, d2):
        # r = x^2 + y^2 - 2a0 x - 2a1 y + (||a||^2 - d2); add r^2
        terms = [(var(i, 0) * 2, 1.0), (var(i, 1) * 2, 1.0),
                 (var(i, 0), -2 * a[0]), (var(i, 1), -2 * a[1]),
                 (np.zeros(nvar, dtype=np.int64),
                  float(a @ a) - d2)]
        for e1, c1 in terms:
            for e2, c2 in terms:
                add(e1 + e2, c1 * c2)

    for i in range(ns):
        for a in anchors:
            d2 = float(((pos[i] - a) ** 2).sum())
            add_sq_residual(i, a, d2)

    t0 = time.time()
    data = dense_sdp_relax(obj, [], nvar, kappa=2)
    res = solve_sdp(data.At, data.b, data.c, data.K.s, tol=1e-4,
                    verbose=True)
    # recover sensor estimates from first-order moments
    est = np.array([[res.X[0, 1 + 2 * i + k] for k in range(2)]
                    for i in range(ns)])
    err = np.abs(est - pos).max()
    print(f"SNL: optimum = {res.obj:0.3e}, eta = {res.eta:0.1e}, "
          f"position error = {err:0.2e}, time = {time.time() - t0:0.2f}s")


if __name__ == "__main__":
    main()
