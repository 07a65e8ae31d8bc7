"""Isolation forest over (rows x trees x points), breadth-synchronous.

The reference's recursive iForest (include/isolation_forest.h:429-499, used
by IsolationForestDeleteOutliers, src/Object.cc:1202-1309) as the reference
package formulates it: all 50 trees of every scored row advance one level
per step, node bounds come from a segment min / max over the subsample,
and every point of every tree is routed in parallel. Parameters as the
reference: 50 trees, subsample psi drawn with replacement from the valid
points, anomaly score 2^(-E[h] / c(psi)).

Random draws: torch cannot replay ``jax.random``. The port's draws come
from a host ``torch.Generator`` (``draw_iforest``): uniforms, split
dimensions and split fractions are drawn on the host, with no data
dependency, and moved to the device; the subsample indices follow from the
uniforms and the point mask on the device by the inverse CDF, as
``jax.random.choice(p=...)`` computes them. ``anomaly_scores`` takes the
draws as an ``IForestDraws``, so the tests can hand it the reference's.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

EULER_GAMMA = 0.5772156649
N_TREES = 50


class IForestDraws(NamedTuple):
    sub_idx: torch.Tensor  # [R, T, psi] int64 subsample point ids
    dims: torch.Tensor     # [R, depth, T, NODES] int64 split dimension
    fracs: torch.Tensor    # [R, depth, T, NODES] float32 split fraction


def _c_factor(n: torch.Tensor) -> torch.Tensor:
    """Average unsuccessful-search path length c(n) of a binary search tree."""
    n = torch.clamp(n.to(torch.float32), min=2.0)
    return 2.0 * (torch.log(n - 1.0) + EULER_GAMMA) - 2.0 * (n - 1.0) / n


def psi_depth_for(n_points_cap: int):
    """Subsample size n/2 (at least 8) and depth limit ceil(log2 psi) (at
    least 3), as the reference sets them."""
    psi = max(n_points_cap // 2, 8)
    depth = max(int(math.ceil(math.log2(psi))), 3)
    return psi, depth


def draw_iforest(generator: torch.Generator, mask: torch.Tensor, psi: int, depth: int,
                 n_trees: int = N_TREES, n_dims: int = 3) -> IForestDraws:
    """One forest's draws per row of ``mask`` [R, N]: host draws from
    ``generator``, the subsample weighted to the row's valid points on the
    mask's device (no host readback)."""
    R, N = mask.shape
    dev = mask.device
    nodes = 1 << depth
    u = torch.rand((R, n_trees * psi), generator=generator).to(dev)
    dims = torch.randint(0, n_dims, (R, depth, n_trees, nodes), generator=generator).to(dev)
    fracs = torch.rand((R, depth, n_trees, nodes), generator=generator).to(dev)
    p = mask.to(torch.float32)
    p = p / torch.clamp(p.sum(-1, keepdim=True), min=1.0)
    cdf = torch.cumsum(p, -1)
    r = cdf[:, -1:] * (1 - u)
    sub_idx = torch.clamp(torch.searchsorted(cdf, r), max=N - 1)
    return IForestDraws(sub_idx.reshape(R, n_trees, psi), dims, fracs)


def _pick_dim(x: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """x: [..., 3], d: [...] -> x[..., d]."""
    return torch.gather(x, -1, d[..., None])[..., 0]


def anomaly_scores(pts: torch.Tensor, mask: torch.Tensor, draws: IForestDraws,
                   depth: int) -> torch.Tensor:
    """Anomaly score in [0, 1] per point, higher = more isolated.
    pts: [R, N, 3], mask: [R, N] (padded slots score 0); one forest per
    row, its draws in ``draws``. Returns [R, N]."""
    R, N, _ = pts.shape
    _, T, psi = draws.sub_idx.shape
    nodes = 1 << depth
    dev = pts.device
    BIG = 1e30
    rows = torch.arange(R, device=dev)[:, None, None]
    sub_pts = pts[rows, draws.sub_idx]                               # [R, T, psi, 3]
    all_pts = pts[:, None].expand(R, T, N, 3)

    sub_nid = torch.zeros((R, T, psi), dtype=torch.int64, device=dev)
    all_nid = torch.zeros((R, T, N), dtype=torch.int64, device=dev)
    sub_h = torch.full((R, T, psi), -1.0, device=dev)
    all_h = torch.full((R, T, N), -1.0, device=dev)
    for level in range(depth):
        # level l has at most 2^l parents and 2^(l+1) children; node ids
        # stay below those counts, so gathers replace the reference's
        # one-hot sums exactly
        n_par = min(1 << level, nodes)
        n_chl = min(n_par * 2, nodes)
        d_l = draws.dims[:, level, :, :n_par]                         # [R, T, n_par]
        f_l = draws.fracs[:, level, :, :n_par]
        sub_dim = _pick_dim(sub_pts, torch.gather(d_l, 2, sub_nid))   # [R, T, psi]
        active_s = sub_h < 0
        seg = torch.where(active_s, sub_nid, n_par)                  # inactive -> dump column
        lo = torch.full((R, T, n_par + 1), BIG, device=dev).scatter_reduce(
            2, seg, sub_dim, "amin")[..., :n_par]
        hi = torch.full((R, T, n_par + 1), -BIG, device=dev).scatter_reduce(
            2, seg, sub_dim, "amax")[..., :n_par]
        split = lo + f_l * (hi - lo)                                  # [R, T, n_par]

        new_sub_nid = torch.where(
            active_s, (sub_nid * 2 + (sub_dim > torch.gather(split, 2, sub_nid)).long()) % nodes,
            sub_nid)
        counts = torch.zeros((R, T, n_chl + 1), dtype=torch.int32, device=dev).scatter_add_(
            2, torch.where(active_s, new_sub_nid, n_chl),
            torch.ones_like(new_sub_nid, dtype=torch.int32))[..., :n_chl]
        sub_cnt = torch.gather(counts, 2, new_sub_nid)
        sub_h = torch.where(active_s & (sub_cnt <= 1), float(level + 1), sub_h)

        a_dim = _pick_dim(all_pts, torch.gather(d_l, 2, all_nid))     # [R, T, N]
        active_a = all_h < 0
        new_all_nid = torch.where(
            active_a, (all_nid * 2 + (a_dim > torch.gather(split, 2, all_nid)).long()) % nodes,
            all_nid)
        a_cnt = torch.gather(counts, 2, new_all_nid)
        all_h = torch.where(active_a & (a_cnt <= 1), float(level + 1), all_h)
        sub_nid, all_nid = new_sub_nid, new_all_nid

    # points the depth limit did not isolate: h = depth + c(leaf size)
    counts_final = torch.zeros((R, T, nodes + 1), dtype=torch.int32, device=dev).scatter_add_(
        2, torch.where(sub_h < 0, sub_nid, nodes),
        torch.ones_like(sub_nid, dtype=torch.int32))[..., :nodes]
    leaf_cnt = torch.gather(counts_final, 2, all_nid)
    h_all = torch.where(all_h >= 0, all_h,
                        depth + torch.where(leaf_cnt >= 2, _c_factor(leaf_cnt),
                                            torch.zeros_like(all_h)))
    e_h = h_all.mean(1)                                               # [R, N]
    score = torch.exp2(-e_h / _c_factor(torch.tensor(float(psi), device=dev)))
    return torch.where(mask, score, torch.zeros_like(score))
