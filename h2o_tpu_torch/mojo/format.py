"""GAM spline bases of the MOJO format (``h2o_tpu/mojo/format.py:364-491``),
copied as plain numpy: the B-spline, natural cubic regression ('cr'),
thin-plate and monotone I-spline bases, and ``gam_basis`` that dispatches
on a GAM column's spec. ``models/gam.py`` builds its penalties from
``cr_matrices`` and ``tp_constraint`` and holds its device bases against
these. The rest of that file — the tree bytecode, ``model.ini`` and the
zip reader and writer — is not ported yet (ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

import numpy as np


def bspline_basis(x: np.ndarray, lo: float, hi: float, interior: np.ndarray,
                  degree: int = 3) -> np.ndarray:
    """(R,) values -> (R, n_basis) cubic B-spline design. NAs/out-of-range are
    clamped to the boundary (constant extrapolation)."""
    x = np.clip(np.nan_to_num(x, nan=(lo + hi) / 2), lo, hi)
    t = np.concatenate([[lo] * (degree + 1), interior, [hi] * (degree + 1)])
    n_basis = len(interior) + degree + 1
    # degree-0: indicator of knot span (right-open; last span right-closed)
    B = np.zeros((len(x), len(t) - 1))
    for i in range(len(t) - 1):
        if t[i + 1] > t[i]:
            B[:, i] = (x >= t[i]) & ((x < t[i + 1]) | (t[i + 1] == hi))
    for d in range(1, degree + 1):
        Bn = np.zeros((len(x), len(t) - 1 - d))
        for i in range(len(t) - 1 - d):
            left = 0.0
            if t[i + d] > t[i]:
                left = (x - t[i]) / (t[i + d] - t[i]) * B[:, i]
            right = 0.0
            if t[i + d + 1] > t[i + 1]:
                right = (t[i + d + 1] - x) / (t[i + d + 1] - t[i + 1]) * B[:, i + 1]
            Bn[:, i] = left + right
        B = Bn
    return B[:, :n_basis]


def cr_basis(x: np.ndarray, knots: np.ndarray, F: np.ndarray) -> np.ndarray:
    """Natural cubic regression spline basis in the values-at-knots
    parameterization (mgcv 'cr', Wood 2006 §4.1.2; the reference's
    `hex/gam/GamSplines/CubicRegressionSplines.java` role). ``F`` maps knot
    values to second derivatives (cr_matrices). Out-of-range clamps."""
    knots = np.asarray(knots, np.float64)
    K = len(knots)
    x = np.clip(np.nan_to_num(np.asarray(x, np.float64),
                              nan=float(knots[K // 2])),
                knots[0], knots[-1])
    j = np.clip(np.searchsorted(knots, x, side="right") - 1, 0, K - 2)
    h = knots[j + 1] - knots[j]
    am = (knots[j + 1] - x) / h
    ap = (x - knots[j]) / h
    cm = ((knots[j + 1] - x) ** 3 / h - h * (knots[j + 1] - x)) / 6.0
    cp = ((x - knots[j]) ** 3 / h - h * (x - knots[j])) / 6.0
    R = len(x)
    B = np.zeros((R, K))
    rows = np.arange(R)
    B[rows, j] += am
    B[rows, j + 1] += ap
    B += cm[:, None] * F[j] + cp[:, None] * F[j + 1]
    return B


def cr_matrices(knots: np.ndarray):
    """(F, S) for the cr basis: F = [0; B⁻¹D; 0] maps knot values to second
    derivatives under natural boundary conditions; S = DᵀB⁻¹D is the exact
    integrated-squared-second-derivative penalty."""
    knots = np.asarray(knots, np.float64)
    K = len(knots)
    h = np.diff(knots)
    D = np.zeros((K - 2, K))
    Bm = np.zeros((K - 2, K - 2))
    for i in range(K - 2):
        D[i, i] = 1.0 / h[i]
        D[i, i + 1] = -1.0 / h[i] - 1.0 / h[i + 1]
        D[i, i + 2] = 1.0 / h[i + 1]
        Bm[i, i] = (h[i] + h[i + 1]) / 3.0
        if i + 1 < K - 2:
            Bm[i, i + 1] = Bm[i + 1, i] = h[i + 1] / 6.0
    Binv_D = np.linalg.solve(Bm, D)
    F = np.vstack([np.zeros(K), Binv_D, np.zeros(K)])
    S = D.T @ Binv_D
    return F, S


def tp_basis(x: np.ndarray, knots: np.ndarray, scale: float,
             Z: np.ndarray) -> np.ndarray:
    """1-D thin-plate regression spline basis: cubic radial bumps |x−k|³
    around each knot, projected through ``Z`` (an orthonormal basis of the
    null space of [1, k]ᵀ — the standard TPRS side constraint that makes the
    radial energy penalty positive semi-definite), plus the linear null-space
    term. ``scale`` normalizes for conditioning."""
    knots = np.asarray(knots, np.float64)
    x = np.nan_to_num(np.asarray(x, np.float64),
                      nan=float(np.median(knots)))
    r = np.abs(x[:, None] - knots[None, :]) / scale
    return np.concatenate([(r ** 3) @ np.asarray(Z, np.float64),
                           (x / scale)[:, None]], axis=1)


def tp_constraint(knots: np.ndarray, scale: float):
    """(Z, S) for the 1-D TPRS: Z spans null([1, k]ᵀ) so the projected
    radial energy S = Zᵀ E Z (E_ij = |k_i−k_j|³) is PSD — the cubic radial
    kernel is only conditionally positive definite orthogonal to {1, x}."""
    knots = np.asarray(knots, np.float64)
    K = len(knots)
    T = np.stack([np.ones(K), knots / scale], axis=1)
    Q, _ = np.linalg.qr(T, mode="complete")
    Z = Q[:, 2:]
    E = np.abs(knots[:, None] - knots[None, :]) ** 3 / scale ** 3
    S = Z.T @ E @ Z
    return Z, (S + S.T) / 2.0


def ispline_basis(x: np.ndarray, lo: float, hi: float, interior: np.ndarray,
                  degree: int = 3) -> np.ndarray:
    """Monotone I-spline basis: I_i(x) = Σ_{j≥i} B_j(x) over the B-spline
    basis (each column rises 0→1, so non-negative coefficients give a
    non-decreasing function — `hex/gam/GamSplines/ISplines.java` role). The
    all-ones j=0 column is dropped (it duplicates the intercept)."""
    B = bspline_basis(x, lo, hi, interior, degree)
    I = np.cumsum(B[:, ::-1], axis=1)[:, ::-1]
    return I[:, 1:]


def gam_basis(x: np.ndarray, spec: dict) -> np.ndarray:
    """Evaluate one gam column's (uncentered) basis from its serialized spec
    — shared by the engine and the standalone MOJO scorer."""
    bs = int(spec.get("bs", 3))
    if bs == 0:      # cr
        return cr_basis(x, np.asarray(spec["knots"]),
                        np.asarray(spec["F"]))
    if bs == 1:      # thin plate (1-D)
        return tp_basis(x, np.asarray(spec["knots"]), float(spec["tp_scale"]),
                        np.asarray(spec["Z"]))
    if bs == 2:      # monotone I-splines
        return ispline_basis(x, spec["lo"], spec["hi"],
                             np.asarray(spec["interior"]), spec["degree"])
    return bspline_basis(x, spec["lo"], spec["hi"],
                         np.asarray(spec["interior"]), spec["degree"])
