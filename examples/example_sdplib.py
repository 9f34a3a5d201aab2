"""SDPLIB instance through the general driver
(the reference feeds SDPLIB data to ManiSDP via fromsdpa)."""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.abspath(
    _os.path.join(_os.path.dirname(__file__), "..")))

import sys
import time

from manisdp import solve_sdp
from manisdp.frontends.sdpa import read_sdpa

SDPLIB = "/root/reference/data/sdplib"


def main():
    name = sys.argv[1] if len(sys.argv) > 1 else "mcp100"
    data = read_sdpa(f"{SDPLIB}/{name}.dat-s")
    if data.K.l:
        raise SystemExit(f"{name}: LP block (K.l={data.K.l}) unsupported")
    if len(data.K.s) > 1:
        from manisdp.solvers.multiblock import solve_multiblock
        t0 = time.time()
        res = solve_multiblock(data.At, data.b, data.c, ns=data.K.s, nob=0)
    else:
        t0 = time.time()
        res = solve_sdp(data.At, data.b, data.c, data.K.s[0])
    print(f"{name}: optimum = {res.obj:0.8f}, eta = {res.eta:0.1e}, "
          f"time = {time.time() - t0:0.2f}s")


if __name__ == "__main__":
    main()
