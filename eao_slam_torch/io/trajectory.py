"""Trajectory evaluation: ATE RMSE after similarity (Sim3 / Umeyama)
alignment, the standard TUM monocular protocol (numpy only)."""

from __future__ import annotations

import numpy as np


def umeyama_alignment(x: np.ndarray, y: np.ndarray, with_scale: bool = True):
    """Least-squares similarity aligning x -> y. x, y: [N, 3].
    Returns (s, R, t) with y ≈ s * R @ x + t."""
    mx, my = x.mean(0), y.mean(0)
    xc, yc = x - mx, y - my
    cov = yc.T @ xc / len(x)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    var_x = (xc ** 2).sum() / len(x)
    s = float(np.trace(np.diag(D) @ S) / var_x) if with_scale else 1.0
    t = my - s * R @ mx
    return s, R, t


def ate_rmse(
    est_t: np.ndarray,
    gt_t: np.ndarray,
    with_scale: bool = True,
) -> float:
    """ATE RMSE after similarity alignment (mono scale is unobservable, so
    scale-aligned comparison matches the standard TUM mono protocol)."""
    s, R, t = umeyama_alignment(est_t, gt_t, with_scale)
    aligned = (s * (R @ est_t.T)).T + t
    err = aligned - gt_t
    return float(np.sqrt((err ** 2).sum(axis=1).mean()))
