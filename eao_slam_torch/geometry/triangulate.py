"""Batched two-view DLT triangulation and the CheckRT-style gates."""

from __future__ import annotations

import torch

from eao_slam_torch.geometry import se3
from eao_slam_torch.geometry.camera import Camera, project


def _dlt_rows(P: torch.Tensor, xn: torch.Tensor) -> torch.Tensor:
    r0 = xn[..., 0:1] * P[..., 2, :] - P[..., 0, :]
    r1 = xn[..., 1:2] * P[..., 2, :] - P[..., 1, :]
    return torch.stack([r0, r1], -2)


def triangulate(T1, T2, xn1, xn2) -> torch.Tensor:
    """World points (..., 3) from normalized correspondences: smallest
    eigenvector of the 4x4 DLT normal matrix (batched eigh)."""
    T1, T2 = torch.broadcast_tensors(T1, T2)
    shape = torch.broadcast_shapes(T1.shape[:-2], xn1.shape[:-1], xn2.shape[:-1])
    T1 = T1.expand(*shape, 3, 4)
    T2 = T2.expand(*shape, 3, 4)
    A = torch.cat([_dlt_rows(T1, xn1.expand(*shape, 2)),
                   _dlt_rows(T2, xn2.expand(*shape, 2))], -2)
    AtA = A.transpose(-1, -2) @ A
    _, V = torch.linalg.eigh(AtA)
    X = V[..., :, 0]
    w = X[..., 3]
    w = torch.where(torch.abs(w) < 1e-12, torch.full_like(w, 1e-12), w)
    return X[..., :3] / w[..., None]


def pixels_to_normalized(cam: Camera, uv: torch.Tensor) -> torch.Tensor:
    return torch.stack([(uv[..., 0] - cam.cx) / cam.fx, (uv[..., 1] - cam.cy) / cam.fy], -1)


def check_triangulation(cam: Camera, T1, T2, Xw, uv1, uv2, sigma2,
                        max_reproj_chi2: float = 5.991,
                        min_parallax_cos: float = 0.9998) -> torch.Tensor:
    """Finite, positive depth in both views, reprojection chi2 under the
    threshold and enough parallax."""
    xc1 = se3.apply(T1, Xw)
    xc2 = se3.apply(T2, Xw)
    ok = (xc1[..., 2] > 1e-6) & (xc2[..., 2] > 1e-6)
    ok = ok & torch.isfinite(Xw).all(-1)
    e1 = project(cam, xc1) - uv1
    e2 = project(cam, xc2) - uv2
    ok = ok & ((e1 * e1).sum(-1) / sigma2 < max_reproj_chi2)
    ok = ok & ((e2 * e2).sum(-1) / sigma2 < max_reproj_chi2)
    c1 = Xw - se3.trans(se3.inverse(T1))
    c2 = Xw - se3.trans(se3.inverse(T2))
    cos_par = (c1 * c2).sum(-1) / (
        torch.linalg.norm(c1, dim=-1) * torch.linalg.norm(c2, dim=-1) + 1e-12)
    return ok & (cos_par < min_parallax_cos)
