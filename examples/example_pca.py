"""Sparse PCA as a POP (reference example/example_pca.m):
min -sum_i (x'v_i)^2 / k  s.t. x_j^3 = x_j (x in {-1,0,1}), sum x^2 = k,
order-2 dense moment relaxation through the generic Lasserre machinery.
"""

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
    d = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    m = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    k = 3
    rs = np.random.RandomState(1)
    V = rs.rand(d, m)

    obj = {}

    def add(e, cv):
        key = tuple(e)
        obj[key] = obj.get(key, 0.0) + cv

    for i in range(m):
        v = V[:, i]
        for a in range(d):
            for b in range(d):
                e = np.zeros(d, dtype=np.int64)
                e[a] += 1
                e[b] += 1
                add(e, -v[a] * v[b] / k)

    eqs = []
    for j in range(d):           # x_j^3 - x_j = 0
        e3 = np.zeros(d, dtype=np.int64)
        e3[j] = 3
        e1 = np.zeros(d, dtype=np.int64)
        e1[j] = 1
        eqs.append({tuple(e3): 1.0, tuple(e1): -1.0})
    sq = {}                      # sum x^2 - k = 0
    for j in range(d):
        e2 = np.zeros(d, dtype=np.int64)
        e2[j] = 2
        sq[tuple(e2)] = 1.0
    sq[tuple(np.zeros(d, dtype=np.int64))] = -float(k)
    eqs.append(sq)

    t0 = time.time()
    data = dense_sdp_relax(obj, eqs, d, kappa=2)
    maxc = np.max(np.abs(data.c))
    res = solve_sdp(data.At, data.b, data.c / maxc, data.K.s,
                    sigma0=1e1, tr_maxiter=8)
    print(f"sparse PCA: optimum = {-res.obj * maxc:0.8f}, "
          f"eta = {res.eta:0.1e}, time = {time.time() - t0:0.2f}s")


if __name__ == "__main__":
    main()
