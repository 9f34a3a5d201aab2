"""Clique-sparse sensor-network localization
(reference example/Sensor_Network_Localization.m + snl_mom_sparse.m).

Chain cliques over sensor pairs -> multiblock moment SDP; the planted
noiseless instance has relaxation value exactly 0."""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.abspath(
    _os.path.join(_os.path.dirname(__file__), "..")))

import sys
import time

import numpy as np

from manisdp.frontends.snl import snl_problem, sparse_moment_relax
from manisdp.solvers.multiblock import solve_multiblock


def main():
    n_sensors = int(sys.argv[1]) if len(sys.argv) > 1 else 3
    seed = 14 if n_sensors == 3 else 1
    obj, nvar, loc = snl_problem(n_sensors, seed=seed)

    # chain cliques over consecutive sensor pairs (vars of sensors i,
    # i+1: coordinates k*n_sensors + i)
    cliques = []
    for i in range(n_sensors - 1):
        cliques.append([i, i + 1, n_sensors + i, n_sensors + i + 1])
    data = sparse_moment_relax(obj, nvar, cliques)
    ns = [int(x) for x in np.atleast_1d(data.K.s)]
    maxc = np.abs(data.c).max()
    t0 = time.time()
    res = solve_multiblock(data.At, data.b, data.c / maxc, ns=ns, nob=0,
                           sigma0=1.0, sigma_min=1e1, theta=1e-3,
                           tr_maxiter=8, alpha=0.01, tol=1e-6,
                           max_outer=300)
    t = time.time() - t0
    print(f"ManiSDP-JAX: optimum = {res.obj * maxc:0.8f} (planted 0), "
          f"eta = {res.eta:0.1e}, blocks = {ns}, time = {t:0.2f}s")


if __name__ == "__main__":
    main()
