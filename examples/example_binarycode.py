"""Binary code design (reference example/BinarycodeDesignPrimal.m):
minimize the autocorrelation sidelobe energy of a +-1 code via the
order-kappa binary Lasserre relaxation and the unit-diagonal driver."""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.abspath(
    _os.path.join(_os.path.dirname(__file__), "..")))

import sys
import time

import numpy as np

from manisdp import solve_unitdiag
from manisdp.frontends.lasserre import dense_sdp_relax


def main():
    N = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    kappa = int(sys.argv[2]) if len(sys.argv) > 2 else 3

    obj = {}

    def add(e, cv):
        key = tuple(int(x) % 2 for x in e)   # binary reduction
        obj[key] = obj.get(key, 0.0) + cv

    # f = sum_k ( sum_i x_i x_{i+k} )^2
    for k in range(1, N - 1):
        pairs = [(i, i + k) for i in range(N - k)]
        for (a1, b1) in pairs:
            for (a2, b2) in pairs:
                e = np.zeros(N, dtype=np.int64)
                for idx in (a1, b1, a2, b2):
                    e[idx] += 1
                add(e, 1.0)

    t0 = time.time()
    data = dense_sdp_relax(obj, [], N, kappa=kappa, binary=True)
    res = solve_unitdiag(data.At, data.b, data.c, data.K.s)
    # brute-force check for small N
    if N <= 14:
        best = np.inf
        for bits in range(2 ** N):
            x = np.array([1.0 if (bits >> i) & 1 else -1.0
                          for i in range(N)])
            val = sum(float(np.dot(x[:N - k], x[k:]) ** 2)
                      for k in range(1, N - 1))
            best = min(best, val)
        print(f"brute-force optimum = {best:0.6f}")
    print(f"binary code design: bound = {res.obj:0.8f}, "
          f"eta = {res.eta:0.1e}, time = {time.time() - t0:0.2f}s")


if __name__ == "__main__":
    main()
