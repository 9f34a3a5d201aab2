"""SDPA reader + SDPLIB certified-optimum regression (SURVEY §4.4:
data/sdplib/README lists certified objective values)."""

import numpy as np
import pytest

from manisdp.frontends.sdpa import read_sdpa
from manisdp.solvers.general import solve_sdp

SDPLIB = "/root/reference/data/sdplib"


def test_reader_roundtrip_mcp100():
    d = read_sdpa(f"{SDPLIB}/mcp100.dat-s")
    assert d.K.s == [100]
    assert d.K.l == 0
    assert len(d.b) == 100
    n = 100
    # mcp: A(X) = diag(X) = b; C symmetric
    A = d.At.T
    C = d.c.reshape(n, n, order="F")
    np.testing.assert_allclose(C, C.T)
    x = np.eye(n).flatten(order="F")
    np.testing.assert_allclose(A @ x, d.b)


def test_mcp100_certified_optimum():
    """mcp100 certified optimum 2.261574e+02 (data/sdplib/README)."""
    d = read_sdpa(f"{SDPLIB}/mcp100.dat-s")
    res = solve_sdp(d.At, d.b, d.c, d.K.s[0], verbose=False)
    assert res.status == 0
    assert res.eta < 1e-8
    np.testing.assert_allclose(-res.obj, 226.1574, rtol=1e-6)


@pytest.mark.slow
def test_mcp124_certified_optimum():
    d = read_sdpa(f"{SDPLIB}/mcp124-1.dat-s")
    res = solve_sdp(d.At, d.b, d.c, d.K.s[0], verbose=False)
    assert res.status == 0
    np.testing.assert_allclose(-res.obj, 141.9905, rtol=1e-6)
