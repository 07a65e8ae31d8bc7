"""3D line segments from semi-dense depth, and multi-view line clustering.

The port of the reference's ``dense/lines3d.py``: ``fit_3d_segments``
(LineDetector::LineFit, src/LineDetector.cc:712-841) samples the
semi-dense inverse-depth field along each 2D segment, back-projects and
fits a robust 3D line (PCA and two IRLS reweightings);
``cluster_world_segments`` (the Line3D++ role) joins world segments of all
keyframes by direction and mutual line distance, a union-find on the host
over the adjacency computed on the device, and merges each cluster by PCA.

Where a plain translation would differ: the median of the residuals is the
mean of the two middle values (``jnp.median`` over an even count; the
lower one is ``torch.median``'s); a fitted direction has no fixed sign in
either package, so a segment's endpoints may come out swapped; a row
without depth samples has a zero covariance, whose eigenvectors differ
between solvers, and is invalid in both.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from eao_slam_torch.dense.semidense import linspace01
from eao_slam_torch.device import fp32_solvers, resolve_device
from eao_slam_torch.geometry import se3
from eao_slam_torch.geometry.camera import Camera
from eao_slam_torch.ops.image import max_filter3


class Segments3D(NamedTuple):
    seg: torch.Tensor     # [L, 6] world (x1 y1 z1 x2 y2 z2)
    valid: torch.Tensor   # [L]


def _median_even(x: torch.Tensor) -> torch.Tensor:
    """``jnp.median`` along the last axis: the mean of the two middle
    values of the sorted row (any NaN gives NaN)."""
    S = x.shape[-1]
    s = torch.sort(x, dim=-1).values
    mid = (s[..., (S - 1) // 2] + s[..., S // 2]) * 0.5
    return torch.where(torch.isnan(x).any(-1), torch.full_like(mid, float("nan")), mid)


def _robust_lines(X: torch.Tensor, w0: torch.Tensor):
    """PCA + two IRLS reweightings per row: X [L, S, 3], w0 [L, S] ->
    (endpoints [L, 6], inlier fraction [L])."""
    w = w0
    c = d = None
    for _ in range(3):
        wn = w / torch.clamp(w.sum(1, keepdim=True), min=1e-9)
        c = (wn[..., None] * X).sum(1)                                  # [L, 3]
        Xc = X - c[:, None]
        cov = torch.einsum("ls,lsi,lsj->lij", wn, Xc, Xc)
        _, V = torch.linalg.eigh(cov)
        d = V[..., -1]                                                  # [L, 3]
        proj = (Xc * d[:, None]).sum(-1)
        res = torch.linalg.norm(Xc - proj[..., None] * d[:, None], dim=-1)
        med = _median_even(torch.where(w0 > 0, res, torch.full_like(res, 1e9)))
        w = w0 * (res < 3.0 * torch.clamp(med, min=1e-3)[:, None])
    s = ((X - c[:, None]) * d[:, None]).sum(-1)
    s_lo = torch.where(w > 0, s, torch.full_like(s, 1e9)).min(1).values
    s_hi = torch.where(w > 0, s, torch.full_like(s, -1e9)).max(1).values
    frac = w.sum(1) / torch.clamp(w0.sum(1), min=1e-9)
    p1 = c + s_lo[:, None] * d
    p2 = c + s_hi[:, None] * d
    return torch.cat([p1, p2], -1), frac


def fit_3d_segments(cam: Camera, segs2d: torch.Tensor, seg_valid: torch.Tensor, px: torch.Tensor,
                    rho: torch.Tensor, px_valid: torch.Tensor, T_cw: torch.Tensor,
                    height: int = 480, width: int = 640, n_samples: int = 32,
                    min_support: float = 0.5) -> Segments3D:
    """World 3D segments [L] of one keyframe's 2D segments [L, 4] from its
    semi-dense pixels [N, 2] and inverse depths [N]: the depths scattered
    (maximum per pixel) and dilated 3x3, ``n_samples`` samples along each
    segment back-projected and fitted. Valid where the segment was, at
    least ``min_support`` of its samples have depth, more than 60 % are
    inliers, and the fit is finite and 0.05-20 m long."""
    fp32_solvers()
    dev = px.device
    xi = torch.clamp(px[:, 0].to(torch.int64), 0, width - 1)
    yi = torch.clamp(px[:, 1].to(torch.int64), 0, height - 1)
    rho_map = torch.zeros(height * width, device=dev).scatter_reduce(
        0, yi * width + xi, torch.where(px_valid, rho, torch.zeros_like(rho)), "amax")
    dil = max_filter3(rho_map.reshape(height, width))

    t = linspace01(n_samples, dev)
    pts = segs2d[:, None, :2] + t[None, :, None] * (segs2d[:, None, 2:] - segs2d[:, None, :2])
    sx = torch.clamp(pts[..., 0], -1.0, float(width)).to(torch.int64).clamp(0, width - 1)
    sy = torch.clamp(pts[..., 1], -1.0, float(height)).to(torch.int64).clamp(0, height - 1)
    r = dil[sy, sx]                                                     # [L, S]
    has_depth = r > 1e-6
    support = has_depth.float().mean(1)

    xn = torch.stack([(pts[..., 0] - cam.cx) / cam.fx, (pts[..., 1] - cam.cy) / cam.fy,
                      torch.ones_like(pts[..., 0])], -1)
    Xc = xn / torch.clamp(r, min=1e-6)[..., None]
    Xw = se3.apply(se3.inverse(T_cw), Xc)                               # [L, S, 3]

    seg3, inlier_frac = _robust_lines(Xw, has_depth.float())
    ok = seg_valid & (support >= min_support) & (inlier_frac > 0.6)
    length = torch.linalg.norm(seg3[:, 3:] - seg3[:, :3], dim=-1)
    ok &= (length > 0.05) & (length < 20.0) & torch.isfinite(seg3).all(-1)
    return Segments3D(seg=seg3, valid=ok)


def segment_affinity(seg: torch.Tensor, valid: torch.Tensor, angle_tol_deg: float = 5.0,
                     dist_tol: float = 0.08) -> torch.Tensor:
    """[N, N] same-line adjacency of world segments [N, 6]: directions
    within ``angle_tol_deg`` and each midpoint within ``dist_tol`` of the
    other's infinite line."""
    fp32_solvers()
    d = seg[:, 3:] - seg[:, :3]
    n = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-9)
    cosang = torch.abs(n @ n.T)
    mid = 0.5 * (seg[:, :3] + seg[:, 3:])
    rel = mid[:, None, :] - seg[None, :, :3]
    proj = (rel * n[None]).sum(-1)
    perp = rel - proj[..., None] * n[None, :, :]
    dist = torch.linalg.norm(perp, dim=-1)
    adj = (cosang > float(np.cos(np.deg2rad(angle_tol_deg)))) & (dist < dist_tol) \
        & (dist.T < dist_tol)
    return adj & valid[:, None] & valid[None, :]


def cluster_world_segments(seg: np.ndarray, valid: np.ndarray, min_views: int = 2,
                           device=None) -> np.ndarray:
    """Union-find over ``segment_affinity`` (computed on ``device``, the
    card unless the caller asks for the CPU; one copy to the host), then one
    segment per cluster of at least ``min_views`` members: the extent of
    the member endpoints along their principal direction (numpy SVD, as the
    reference). seg [N, 6] numpy, one row per keyframe segment. Returns
    [M, 6]."""
    dev = resolve_device(device)
    seg = np.asarray(seg)
    valid = np.asarray(valid)
    adj = segment_affinity(torch.as_tensor(seg, dtype=torch.float32, device=dev),
                           torch.as_tensor(valid, device=dev)).cpu().numpy()
    N = len(seg)
    parent = np.arange(N)

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for i in range(N):
        if not valid[i]:
            continue
        for j in np.nonzero(adj[i])[0]:
            if j > i:
                ra, rb = find(i), find(j)
                if ra != rb:
                    parent[rb] = ra

    clusters = {}
    for i in range(N):
        if valid[i]:
            clusters.setdefault(find(i), []).append(i)
    merged = []
    for members in clusters.values():
        if len(members) < min_views:
            continue
        ends = seg[members].reshape(-1, 3)
        c = ends.mean(0)
        _, _, Vt = np.linalg.svd(ends - c)
        d = Vt[0]
        s = (ends - c) @ d
        merged.append(np.concatenate([c + s.min() * d, c + s.max() * d]))
    return np.asarray(merged).reshape(-1, 6)


def save_lines_obj(path: str, segments: np.ndarray) -> int:
    """.obj export with line elements (LineDetector's SaveLines): two
    ``v`` rows and one ``l`` row per segment. Returns the count."""
    with open(path, "w") as f:
        for s in segments:
            f.write(f"v {s[0]:.5f} {s[1]:.5f} {s[2]:.5f}\n")
            f.write(f"v {s[3]:.5f} {s[4]:.5f} {s[5]:.5f}\n")
        for i in range(len(segments)):
            f.write(f"l {2*i+1} {2*i+2}\n")
    return len(segments)
