"""Format converters: svec/smat inverses and SeDuMi<->SDPT3 roundtrip."""

import numpy as np
import scipy.sparse as sp

from manisdp.frontends.convert import (sdpt3_to_sedumi, sedumi_to_mosek,
                                       sedumi_to_sdpt3, smat, svec)
from manisdp.frontends.sedumi import Cone, SedumiData

RNG = np.random.RandomState(0)


def random_sedumi(n=6, m=5, f=2, l=3):
    tot = f + l + n * n
    At_rows = []
    for k in range(m):
        v = np.zeros(tot)
        v[:f + l] = RNG.randn(f + l)
        M = RNG.randn(n, n)
        M = 0.5 * (M + M.T)
        v[f + l:] = M.flatten(order="F")
        At_rows.append(v)
    At = sp.csc_matrix(np.stack(At_rows, axis=1))
    b = RNG.randn(m)
    C = RNG.randn(n, n)
    C = 0.5 * (C + C.T)
    c = np.concatenate([RNG.randn(f + l), C.flatten(order="F")])
    return SedumiData(At=At, b=b, c=c, K=Cone(s=n, f=f, l=l))


def test_svec_smat_roundtrip():
    n = 7
    M = RNG.randn(n, n)
    M = 0.5 * (M + M.T)
    v = svec(M, n)
    assert v.shape == (n * (n + 1) // 2,)
    np.testing.assert_allclose(smat(v, n), M, atol=1e-14)
    # isometry: <M, M> = <svec, svec>
    np.testing.assert_allclose(np.dot(v, v), np.sum(M * M), rtol=1e-14)


def test_sedumi_sdpt3_roundtrip():
    data = random_sedumi()
    t3 = sedumi_to_sdpt3(data)
    back = sdpt3_to_sedumi(t3["blk"], t3["At"], t3["C"], t3["b"])
    np.testing.assert_allclose(back.b, data.b)
    np.testing.assert_allclose(back.c, data.c, atol=1e-12)
    np.testing.assert_allclose(back.At.toarray(), data.At.toarray(),
                               atol=1e-12)
    assert back.K.f == data.K.f and back.K.l == data.K.l
    assert back.K.s == [6]


def test_sedumi_to_mosek_objective_consistency():
    """<C, X> computed from the barc triplets (lower triangle with
    doubled off-diag) matches the SeDuMi objective."""
    data = random_sedumi(n=5, m=4, f=0, l=0)
    task = sedumi_to_mosek(data)
    n = 5
    X = RNG.randn(n, n)
    X = X @ X.T
    ref = float(data.c @ X.flatten(order="F"))
    acc = 0.0
    bc = task["barc"]
    for k, l, v in zip(bc["subk"], bc["subl"], bc["val"]):
        acc += v * X[k, l] * (1.0 if k == l else 2.0)
    np.testing.assert_allclose(acc, ref, rtol=1e-12)
