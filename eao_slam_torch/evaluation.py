"""Offline reconstruction evaluation (the reference's eval/*.m pipeline).

The port of the reference's ``evaluation.py``: downsample the estimated and
the ground-truth clouds, register them with scaled trimmed ICP (a
closed-form Umeyama similarity per iteration), then report the mean
distance of the estimated vertices to their nearest ground-truth vertex.
Nearest neighbours are chunked [C, M] distance tiles on the device; the
product inside stays in full float32 (TF32 would cost about three digits of
the distances). Clouds load from .obj, ascii .ply or xyz rows.
"""

from __future__ import annotations

import numpy as np
import torch

from eao_slam_torch.device import fp32_solvers, resolve_device
from eao_slam_torch.io.trajectory import umeyama_alignment


def load_cloud(path: str) -> np.ndarray:
    """Vertices [N, 3] float64 from .obj (``v x y z`` rows), ascii .ply, or
    plain whitespace-separated xyz rows."""
    pts = []
    if path.endswith(".ply"):
        with open(path, "rb") as f:
            header = []
            while True:
                line = f.readline().decode("ascii", "ignore").strip()
                header.append(line)
                if line == "end_header":
                    break
            n = next(int(h.split()[-1]) for h in header if h.startswith("element vertex"))
            fmt = next((h for h in header if h.startswith("format")), "ascii")
            if "ascii" not in fmt:
                raise ValueError("only ascii .ply supported")
            for _ in range(n):
                vals = f.readline().split()
                pts.append([float(v) for v in vals[:3]])
        return np.asarray(pts, np.float64)
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                pts.append([float(v) for v in parts[1:4]])
            elif parts[0][0] not in "#vfgl" and len(parts) >= 3:
                try:
                    pts.append([float(v) for v in parts[:3]])
                except ValueError:
                    continue
    return np.asarray(pts, np.float64)


def random_downsample(points: np.ndarray, rate: float = 0.1, seed: int = 0) -> np.ndarray:
    """``pcdownsample(..., 'random', rate)`` (eval/downsample.m): a sorted
    random subset of round(n * rate) points."""
    n = len(points)
    k = max(1, int(round(n * rate)))
    idx = np.random.default_rng(seed).choice(n, size=min(k, n), replace=False)
    return points[np.sort(idx)]


def voxel_downsample(points: np.ndarray, voxel: float) -> np.ndarray:
    """One (mean) point per occupied voxel."""
    keys = np.floor(points / voxel).astype(np.int64)
    _, inv, counts = np.unique(keys, axis=0, return_inverse=True, return_counts=True)
    sums = np.zeros((len(counts), 3))
    np.add.at(sums, inv.reshape(-1), points)
    return sums / counts[:, None]


def _sq_norm(x: torch.Tensor) -> torch.Tensor:
    """Row sums of squares [N, 3] -> [N] float32 as XLA's CPU reduction
    forms them, x2 x2 + (x1 x1 + x0 x0) with fused multiply-adds (each
    product exact in float64, one rounding per addition). Another order
    moves the last bit, and the distance tile's cancellation shows it."""
    x64 = x.double()
    s = x[:, 0] * x[:, 0]
    s = (x64[:, 1] * x64[:, 1] + s.double()).float()
    return (x64[:, 2] * x64[:, 2] + s.double()).float()


def _nn_chunk(chunk: torch.Tensor, ref: torch.Tensor):
    """[C, 3] x [M, 3] -> (idx [C], dist [C]) through one distance tile."""
    d2 = _sq_norm(chunk)[:, None] + _sq_norm(ref)[None, :] - 2.0 * chunk @ ref.T
    idx = torch.argmin(d2, dim=1)
    return idx, torch.sqrt(torch.clamp(torch.gather(d2, 1, idx[:, None])[:, 0], min=0.0))


def nearest_neighbors(query: np.ndarray, ref: np.ndarray, chunk: int = 4096, device=None):
    """Nearest ref vertex of each query vertex, in float32 on ``device``
    (the card unless the caller asks for the CPU): (idx [N], dist [N])."""
    fp32_solvers()
    dev = resolve_device(device)
    ref_t = torch.as_tensor(np.asarray(ref, np.float32), device=dev)
    q_all = torch.as_tensor(np.asarray(query, np.float32), device=dev)
    idxs, dists = [], []
    for s in range(0, len(query), chunk):
        i, d = _nn_chunk(q_all[s:s + chunk], ref_t)
        idxs.append(i)
        dists.append(d)
    if not idxs:
        return np.zeros(0, np.int64), np.zeros(0, np.float32)
    return torch.cat(idxs).cpu().numpy(), torch.cat(dists).cpu().numpy()


def icp_register(src: np.ndarray, dst: np.ndarray, iters: int = 30, with_scale: bool = True,
                 trim: float = 0.9, init: tuple = None, device=None):
    """Scaled trimmed ICP: (s, R, t) with dst ~ s R src + t. Each iteration
    matches every src point to its nearest dst point, keeps the closest
    ``trim`` share and solves the similarity in closed form (Umeyama);
    without ``init`` it starts from the centroids and the RMS radii."""
    if init is None:
        ms, md = src.mean(0), dst.mean(0)
        rs = np.sqrt(((src - ms) ** 2).sum(1).mean())
        rd = np.sqrt(((dst - md) ** 2).sum(1).mean())
        s = float(rd / max(rs, 1e-12))
        R = np.eye(3)
        t = md - s * R @ ms
    else:
        s, R, t = init
    for _ in range(iters):
        moved = (s * (R @ src.T)).T + t
        idx, dist = nearest_neighbors(moved, dst, device=device)
        keep = dist <= np.quantile(dist, trim) if trim < 1.0 else np.ones(len(dist), bool)
        if keep.sum() < 4:
            break
        s2, R2, t2 = umeyama_alignment(src[keep], dst[idx[keep]], with_scale)
        converged = (abs(s2 - s) < 1e-9 and np.allclose(R2, R, atol=1e-9)
                     and np.allclose(t2, t, atol=1e-9))
        s, R, t = s2, R2, t2
        if converged:
            break
    return s, R, t


def mean_cloud_distance(est: np.ndarray, gt: np.ndarray, transform: tuple = None,
                        device=None) -> float:
    """Mean distance of the estimated vertices (moved by ``transform``,
    (s, R, t)) to their nearest ground-truth vertex (eval/evaluate.m)."""
    if transform is not None:
        s, R, t = transform
        est = (s * (R @ est.T)).T + t
    _, dist = nearest_neighbors(est, gt, device=device)
    return float(dist.mean())


def evaluate_reconstruction(est_path: str, gt_path: str, downsample_rate: float = 0.1,
                            icp_iters: int = 30, device=None) -> dict:
    """The eval/ pipeline on files: downsample both clouds, register the
    downsampled clouds by scaled ICP, then the mean vertex distance of the
    whole estimated cloud under that transform."""
    est = load_cloud(est_path)
    gt = load_cloud(gt_path)
    est_d = random_downsample(est, downsample_rate, seed=1)
    gt_d = random_downsample(gt, downsample_rate, seed=2)
    s, R, t = icp_register(est_d, gt_d, iters=icp_iters, device=device)
    return {"scale": float(s), "mean_distance": mean_cloud_distance(est, gt, (s, R, t), device),
            "n_est": int(len(est)), "n_gt": int(len(gt))}
