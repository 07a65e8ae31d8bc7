"""EPnP + RANSAC: absolute pose from 2D-3D matches for relocalization.

All hypotheses run as one batch: each draws ``sample_size``
correspondences, solves the EPnP case-1 system (null vector of M^T M
scaled to preserve the control-point distances), recovers (R, t) by rigid
Horn alignment and scores inliers by reprojection chi2. The winner is
polished by the robust pose LM (``solvers/pose_lm.py``) on its consensus
set. Same construction as the reference package's ``solvers/pnp.py``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from eao_slam_torch.device import fp32_solvers
from eao_slam_torch.geometry import se3
from eao_slam_torch.geometry.camera import Camera, project
from eao_slam_torch.solvers.init2view import sample_hypotheses
from eao_slam_torch.solvers.pose_lm import optimize_pose

CHI2_PNP = 5.991


def _control_points(X: torch.Tensor) -> torch.Tensor:
    """EPnP control points: centroid + principal axes. X [B, n, 3] -> [B, 4, 3]."""
    c0 = X.mean(-2)
    Xc = X - c0[..., None, :]
    cov = torch.einsum("bni,bnj->bij", Xc, Xc) / X.shape[-2]
    eigval, eigvec = torch.linalg.eigh(cov)
    scale = torch.sqrt(torch.clamp(eigval, min=1e-9))
    return torch.cat([c0[:, None], c0[:, None] + scale[..., :, None] * eigvec.transpose(-1, -2)], -2)


def _barycentric(X: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """alphas with X = sum_j a_j C_j, sum a = 1. X [B, n, 3] -> [B, n, 4]."""
    ones = torch.ones_like(C[..., :1, :1]).expand(C.shape[0], 1, 4)
    M = torch.cat([C.transpose(-1, -2), ones], -2)                         # [B, 4, 4]
    Xh = torch.cat([X, torch.ones_like(X[..., :1])], -1)                   # [B, n, 4]
    return (torch.linalg.inv(M) @ Xh.transpose(-1, -2)).transpose(-1, -2)


def _rigid_horn(x: torch.Tensor, y: torch.Tensor):
    """Rigid y ~ R x + t (no scale). x, y [B, n, 3]."""
    mx, my = x.mean(-2), y.mean(-2)
    cov = (y - my[:, None]).transpose(-1, -2) @ (x - mx[:, None])
    U, _, Vt = torch.linalg.svd(cov)
    det = torch.linalg.det(U @ Vt)
    D = torch.stack([torch.ones_like(det), torch.ones_like(det), det], -1)
    R = U @ (D[..., :, None] * Vt)
    t = my - (R @ mx[..., None])[..., 0]
    return R, t


def epnp(cam: Camera, X: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """EPnP case-1 poses of a batch of samples. X [B, n, 3], uv [B, n, 2]
    -> [B, 3, 4] (the reference's ``_epnp_once``, batched)."""
    B, n = X.shape[:2]
    C = _control_points(X)
    A = _barycentric(X, C)                                                 # [B, n, 4]
    u = (uv[..., 0] - cam.cx) / cam.fx
    v = (uv[..., 1] - cam.cy) / cam.fy
    # rows: sum_j a_j (x_j - u z_j) = 0 ; sum_j a_j (y_j - v z_j) = 0
    zeros = torch.zeros_like(A)
    row_u = torch.stack([A, zeros, -A * u[..., None]], -1).reshape(B, n, 12)
    row_v = torch.stack([zeros, A, -A * v[..., None]], -1).reshape(B, n, 12)
    M = torch.cat([row_u, row_v], -2)                                      # [B, 2n, 12]
    _, V = torch.linalg.eigh(M.transpose(-1, -2) @ M)
    x = V[..., :, 0].reshape(B, 4, 3)   # control points in the camera, up to beta

    # case-1 beta: preserve inter-control-point distances
    dC = torch.linalg.norm(C[:, :, None] - C[:, None, :], dim=-1)
    dx = torch.linalg.norm(x[:, :, None] - x[:, None, :], dim=-1)
    beta = (dx * dC).sum((-1, -2)) / torch.clamp((dx * dx).sum((-1, -2)), min=1e-12)
    Cc = beta[:, None, None] * x
    # cheirality: points must end up in front of the camera
    pc = A @ Cc
    flip = torch.where(pc[..., 2].sum(-1) < 0, -1.0, 1.0)
    Cc = Cc * flip[:, None, None]
    R, t = _rigid_horn(C, Cc)
    return se3.make(R, t)


class PnPResult(NamedTuple):
    T: torch.Tensor
    inliers: torch.Tensor
    n_inliers: torch.Tensor
    success: torch.Tensor


def pnp_ransac(cam: Camera, Xw, uv, valid, inv_sigma2,
               generator: Optional[torch.Generator] = None,
               n_hyp: int = 192, sample_size: int = 8, min_inliers: int = 12,
               hyp_idx: Optional[torch.Tensor] = None) -> PnPResult:
    """Batched-hypothesis EPnP RANSAC + robust LM polish. ``hyp_idx``
    [n_hyp, sample_size] overrides the generator's draws."""
    fp32_solvers()
    if hyp_idx is None:
        hyp_idx = sample_hypotheses(valid, n_hyp, generator, sample_size)
    hyp_idx = hyp_idx.long().to(Xw.device)
    Ts = epnp(cam, Xw[hyp_idx], uv[hyp_idx])                               # [B, 3, 4]

    xc = se3.apply(Ts[:, None], Xw[None])                                  # [B, N, 3]
    r = project(cam, xc) - uv[None]
    chi2 = (r * r).sum(-1) * inv_sigma2[None]
    inl = valid[None] & (xc[..., 2] > 0.05) & (chi2 < CHI2_PNP)
    best = torch.argmax(inl.sum(1))
    res = optimize_pose(cam, Ts[best], Xw, uv, inv_sigma2, inl[best])
    return PnPResult(T=res.T, inliers=res.inliers, n_inliers=res.n_inliers,
                     success=res.n_inliers >= min_inliers)
