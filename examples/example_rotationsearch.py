"""Robust rotation search (Wahba with outliers) — the QUASAR SDP
(reference example/example_rotationsearch.m, which loads
CertifiablyRobustPerception data; here the SDP is built from synthetic
measurements).

TLS formulation over the lifted variable Z = [q; th_1 q; ...; th_N q],
X = ZZ' of size 4(N+1):
  cost  sum_i <Q_i, X_00>/2 + <Q_i - cbar^2 I, X_0i>/2 + N cbar^2/2
  s.t.  X_ii = X_00,  X_0i symmetric,  tr(X) = N + 1,  X >= 0
solved on the unit-trace manifold after scaling b by 1/(N+1)
(example_rotationsearch.m:36)."""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.abspath(
    _os.path.join(_os.path.dirname(__file__), "..")))

import sys
import time

import numpy as np
import scipy.sparse as sp

from manisdp import solve_unittrace


def quat_rot(q):
    """Rotation matrix of a (unit) quaternion q = [x, y, z, w],
    homogeneous quadratic in q."""
    x, y, z, w = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def residual_quadratic(a, b):
    """Q with q'Qq = ||b - R(q) a||^2 on the unit sphere: Q =
    (|a|^2+|b|^2) I - 2 H, H built numerically from the homogeneous
    bilinear form q'Hq = b'R(q)a."""
    def f(q):
        # homogeneous version: R entries with (1 - 2(..)) -> (q'q - 2(..))
        x, y, z, w = q
        n2 = x * x + y * y + z * z + w * w
        R = np.array([
            [n2 - 2 * (y * y + z * z), 2 * (x * y - z * w),
             2 * (x * z + y * w)],
            [2 * (x * y + z * w), n2 - 2 * (x * x + z * z),
             2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w),
             n2 - 2 * (x * x + y * y)],
        ])
        return float(b @ R @ a)

    H = np.zeros((4, 4))
    E = np.eye(4)
    for k in range(4):
        H[k, k] = f(E[k])
    for k in range(4):
        for l in range(k + 1, 4):
            H[k, l] = H[l, k] = 0.5 * (
                f(E[k] + E[l]) - H[k, k] - H[l, l])
    return (a @ a + b @ b) * np.eye(4) - 2.0 * H


def build_quasar(A_pts, B_pts, cbar2):
    N = A_pts.shape[1]
    n = 4 * (N + 1)
    Qs = [residual_quadratic(A_pts[:, i], B_pts[:, i]) for i in range(N)]

    C = np.zeros((n, n))
    C[:4, :4] = 0.5 * sum(Qs) + 0.5 * N * cbar2 * np.eye(4)
    for i in range(1, N + 1):
        blkC = 0.25 * (Qs[i - 1] - cbar2 * np.eye(4))
        C[:4, 4 * i:4 * i + 4] += blkC
        C[4 * i:4 * i + 4, :4] += blkC

    rows, cols, vals, bvals = [], [], [], []
    l = 0
    for i in range(1, N + 1):
        o = 4 * i
        # X_ii = X_00 (upper triangle)
        for r in range(4):
            for cc in range(r, 4):
                rows += [(o + cc) * n + (o + r), cc * n + r]
                cols += [l, l]
                vals += [1.0, -1.0]
                if r != cc:
                    rows += [(o + r) * n + (o + cc), r * n + cc]
                    cols += [l, l]
                    vals += [1.0, -1.0]
                bvals.append(0.0)
                l += 1
        # X_0i symmetric: skew part zero
        for r in range(4):
            for cc in range(r + 1, 4):
                rows += [(o + cc) * n + r, (o + r) * n + cc,
                         r * n + (o + cc), cc * n + (o + r)]
                cols += [l, l, l, l]
                vals += [0.5, -0.5, 0.5, -0.5]
                bvals.append(0.0)
                l += 1
    At = sp.coo_matrix((vals, (rows, cols)), shape=(n * n, l)).tocsc()
    return At, np.asarray(bvals), C.flatten(order="F"), n


def main():
    N = int(sys.argv[1]) if len(sys.argv) > 1 else 10
    outrate = 0.3
    rs = np.random.RandomState(0)
    q_true = rs.randn(4)
    q_true /= np.linalg.norm(q_true)
    R_true = quat_rot(q_true)
    A_pts = rs.randn(3, N)
    A_pts /= np.linalg.norm(A_pts, axis=0)
    B_pts = R_true @ A_pts + 0.01 * rs.randn(3, N)
    n_out = int(outrate * N)
    B_pts[:, :n_out] = rs.randn(3, n_out)
    B_pts /= np.linalg.norm(B_pts, axis=0)
    cbar2 = 0.1

    At, b, c, n = build_quasar(A_pts, B_pts, cbar2)
    t0 = time.time()
    # "rs" recipe from the reference's example/settings.txt:38-47
    res = solve_unittrace(At, b / (N + 1), c, n, sigma0=1e1,
                          sigma_min=1e2, theta=1e-2, delta=10,
                          tr_maxinner=40, tr_maxiter=3, tau1=1 / 6e3,
                          tau2=10 / 6e3, line_search=True)
    # recover q from the top block of X (scaled by N+1)
    X00 = (N + 1) * res.X[:4, :4]
    w, V = np.linalg.eigh(X00)
    q_est = V[:, -1]
    err = min(np.linalg.norm(q_est - q_true),
              np.linalg.norm(q_est + q_true))
    print(f"QUASAR: optimum = {res.obj * (N + 1):0.6f}, "
          f"eta = {res.eta:0.1e}, |q_est - q_true| = {err:0.2e}, "
          f"time = {time.time() - t0:0.2f}s")


if __name__ == "__main__":
    main()
