"""ctypes bindings for the native CPU kernels (csrc/manisdp_kernels.cpp).

The device compute path never calls these; they are the C++ counterpart
of the reference's MEX kernel set (with corrected semantics, SURVEY
§2.3) and serve as an independent host-side reference implementation
for property-testing the masked-product geometry, plus a fast CPU
``apply_factored`` for verification.  Built on demand with make.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_CSRC = os.path.join(os.path.dirname(__file__), "..", "..", "csrc")
_LIB_PATH = os.path.join(_CSRC, "libmanisdp_kernels.so")
_lib: Optional[ctypes.CDLL] = None


def _build():
    subprocess.run(["make", "-C", _CSRC], check=True,
                   capture_output=True)


def load() -> ctypes.CDLL:
    """Load (building if needed) the native kernel library."""
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        _build()
    lib = ctypes.CDLL(_LIB_PATH)
    dp = ctypes.POINTER(ctypes.c_double)
    ip = ctypes.POINTER(ctypes.c_int64)
    lib.msdp_inner.restype = ctypes.c_double
    lib.msdp_inner.argtypes = [ctypes.c_int64, dp, dp]
    lib.msdp_lincomb.argtypes = [ctypes.c_int64, ctypes.c_double, dp,
                                 ctypes.c_double, dp, dp]
    lib.msdp_proj.argtypes = [ctypes.c_int64, ctypes.c_int64, ip, ip,
                              dp, dp, dp]
    lib.msdp_retr.argtypes = [ctypes.c_int64, ctypes.c_int64, ip, ip,
                              dp, dp, dp]
    lib.msdp_rand.argtypes = [ctypes.c_uint64, ctypes.c_int64,
                              ctypes.c_int64, ip, ip, dp]
    lib.msdp_zerovec.argtypes = [ctypes.c_int64, dp]
    lib.msdp_mat_symmetrize.argtypes = [ctypes.c_int64, dp, dp]
    lib.msdp_apply_factored.argtypes = [ctypes.c_int64, ip, ip, ip, dp,
                                        dp, dp, ctypes.c_int64, dp]
    _lib = lib
    return lib


def _dp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _ip(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


class MultiblockKernels:
    """Reference CPU implementation of the product-manifold ops on a
    cell-array-of-blocks layout: blocks[i] is (p_i, n_i) float64, held
    internally as one contiguous column-major buffer per call."""

    def __init__(self, ps, ns, nob: int):
        self.ps = np.asarray(ps, dtype=np.int64)
        self.ns = np.asarray(ns, dtype=np.int64)
        self.nob = int(nob)
        self.sizes = self.ps * self.ns
        self.total = int(self.sizes.sum())
        self.lib = load()

    def _flat(self, blocks):
        return np.concatenate(
            [np.asarray(b, dtype=np.float64).flatten(order="F")
             for b in blocks])

    def _unflat(self, flat):
        out, off = [], 0
        for p, n in zip(self.ps, self.ns):
            out.append(flat[off:off + p * n].reshape(p, n, order="F"))
            off += p * n
        return out

    def inner(self, u_blocks, v_blocks) -> float:
        u = self._flat(u_blocks)
        v = self._flat(v_blocks)
        return float(self.lib.msdp_inner(self.total, _dp(u), _dp(v)))

    def lincomb(self, a1, u1_blocks, a2=None, u2_blocks=None):
        u1 = self._flat(u1_blocks)
        out = np.empty(self.total)
        if u2_blocks is None:
            self.lib.msdp_lincomb(self.total, a1, _dp(u1), 0.0,
                                  None, _dp(out))
        else:
            u2 = self._flat(u2_blocks)
            self.lib.msdp_lincomb(self.total, a1, _dp(u1), a2,
                                  _dp(u2), _dp(out))
        return self._unflat(out)

    def proj(self, x_blocks, u_blocks):
        x = self._flat(x_blocks)
        u = self._flat(u_blocks)
        out = np.empty(self.total)
        self.lib.msdp_proj(len(self.ps), self.nob, _ip(self.ps),
                           _ip(self.ns), _dp(x), _dp(u), _dp(out))
        return self._unflat(out)

    def retr(self, x_blocks, u_blocks):
        x = self._flat(x_blocks)
        u = self._flat(u_blocks)
        out = np.empty(self.total)
        self.lib.msdp_retr(len(self.ps), self.nob, _ip(self.ps),
                           _ip(self.ns), _dp(x), _dp(u), _dp(out))
        return self._unflat(out)

    def rand(self, seed: int):
        out = np.empty(self.total)
        self.lib.msdp_rand(seed, len(self.ps), self.nob, _ip(self.ps),
                           _ip(self.ns), _dp(out))
        return self._unflat(out)

    def zerovec(self):
        out = np.empty(self.total)
        self.lib.msdp_zerovec(self.total, _dp(out))
        return self._unflat(out)


def mat_symmetrize(vec: np.ndarray, n: int) -> np.ndarray:
    """SDPT3 `mexmat`: column-major vec -> symmetrized dense n x n."""
    lib = load()
    v = np.ascontiguousarray(vec, dtype=np.float64)
    out = np.empty(n * n)
    lib.msdp_mat_symmetrize(n, _dp(v), _dp(out))
    return out.reshape(n, n, order="F")


def apply_factored_cpu(indptr, ii, jj, vv, Y, U=None) -> np.ndarray:
    """CPU-native A(vec(Y'U)) from CSR-by-constraint entries; Y, U are
    (p, n) row-major factors (columns contiguous after transpose)."""
    lib = load()
    Yt = np.ascontiguousarray(np.asarray(Y).T)      # (n, p) rows=columns
    Ut = Yt if U is None else np.ascontiguousarray(np.asarray(U).T)
    m = len(indptr) - 1
    p = Yt.shape[1]
    w = np.empty(m)
    lib.msdp_apply_factored(
        m, _ip(np.ascontiguousarray(indptr, dtype=np.int64)),
        _ip(np.ascontiguousarray(ii, dtype=np.int64)),
        _ip(np.ascontiguousarray(jj, dtype=np.int64)),
        _dp(np.ascontiguousarray(vv, dtype=np.float64)),
        _dp(Yt), _dp(Ut), p, _dp(w))
    return w
