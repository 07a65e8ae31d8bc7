"""2D line segments by tiled, gradient-guided Hough voting.

The reference package's stand-in for EDLines (src/Frame.cc:324-335): the
image splits into 120 x 160 tiles; in each tile every pixel whose Sobel
magnitude clears the tile's adaptive threshold (the larger of
``grad_thresh`` and 1.5 times the tile's mean magnitude) votes for the
(theta, rho) cell of the line normal to its gradient (90 theta bins of 2
degrees, rho bins of 3 px); peaks of the accumulator under a 3x3 maximum
filter score the sum of their 3x3 neighbourhood, each tile keeps its K
best, and a peak's segment is the longest run of occupied bins (128 bins
along the line, gaps of up to 2 bins closed) of its inlier pixels (within
4.5 px of the line, gradient within 10 degrees of its normal). The
strongest ``max_lines`` segments of the frame are returned.

Everything is batched over the frames of a chunk. The votes and the run
occupancy are scatter-adds of integer counts (the reference builds them
as one-hot matrix products, a TPU formulation; the counts are the same).
The endpoint search works on a [frames, tiles, K, 120 x 160] grid, so it
runs FRAMES_PER_PASS frames at a time to bound its memory (about 100 MB a
float32 tensor at VGA, K = 10).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from eao_slam_torch.objects.association import _top_k
from eao_slam_torch.ops.image import sobel_gradients

N_THETA = 90            # 2-degree bins over [0, pi)
RHO_BIN = 3.0           # px
TILE_H, TILE_W = 120, 160
TILE_DIAG = float(np.hypot(TILE_H, TILE_W))
N_RHO = int(2 * TILE_DIAG / RHO_BIN) + 2
SBINS = 128             # occupancy bins along a line
S_SCALE = SBINS / (2.0 * TILE_DIAG)
ANGLE_TOL = float(np.float32(np.deg2rad(10.0)))   # inlier gradient tolerance
FRAMES_PER_PASS = 8


class HoughBins(NamedTuple):
    """The per-pixel votes of a batch of tiled images, [C, T, TH, TW]."""

    t_bin: torch.Tensor   # int32 theta bin
    r_bin: torch.Tensor   # int32 rho bin
    strong: torch.Tensor  # bool: the pixel votes
    theta: torch.Tensor   # float32 gradient direction mod pi
    ntx: int              # tiles across the image


def _theta_centers(device) -> torch.Tensor:
    return (torch.arange(N_THETA, dtype=torch.float32, device=device) + 0.5) * (math.pi / N_THETA)


def hough_bins(img: torch.Tensor, grad_thresh: float = 40.0) -> HoughBins:
    """[C, H, W] float32 -> the tiled per-pixel votes (edge pixels, their
    theta and rho bins). Images that are not a whole number of tiles are
    padded with zero gradient."""
    C, H, W = img.shape
    nty, ntx = -(-H // TILE_H), -(-W // TILE_W)
    Hp, Wp = nty * TILE_H, ntx * TILE_W
    gx, gy, mag = sobel_gradients(img)
    if (Hp, Wp) != (H, W):
        gx, gy, mag = (torch.nn.functional.pad(a, (0, Wp - W, 0, Hp - H)) for a in (gx, gy, mag))

    def tile(a):
        return a.reshape(C, nty, TILE_H, ntx, TILE_W).permute(0, 1, 3, 2, 4).reshape(
            C, nty * ntx, TILE_H, TILE_W)

    gx, gy, mag = tile(gx), tile(gy), tile(mag)
    thr = torch.clamp(1.5 * mag.mean(dim=(2, 3)), min=grad_thresh)[..., None, None]
    strong = mag > thr
    dev = img.device
    ys = torch.arange(TILE_H, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(TILE_W, dtype=torch.float32, device=dev)[None, :]
    # theta parametrizes the line normal, i.e. the gradient direction mod pi
    theta = torch.remainder(torch.atan2(gy, gx), math.pi)
    t_bin = torch.clamp((theta / math.pi * N_THETA).to(torch.int32), 0, N_THETA - 1)
    tc = _theta_centers(dev)
    tb = t_bin.long()
    rho = xs * torch.cos(tc)[tb] + ys * torch.sin(tc)[tb]
    r_bin = torch.clamp(((rho + TILE_DIAG) / RHO_BIN).to(torch.int32), 0, N_RHO - 1)
    return HoughBins(t_bin, r_bin, strong, theta, ntx)


def vote_accumulator(bins: HoughBins) -> torch.Tensor:
    """[C, T, N_THETA, N_RHO] float32 vote counts of each tile: one
    scatter-add of the edge pixels over (frame, tile, theta, rho)."""
    C, T = bins.t_bin.shape[:2]
    dev = bins.t_bin.device
    cells = N_THETA * N_RHO
    cell = bins.t_bin.long() * N_RHO + bins.r_bin.long()
    base = torch.arange(C * T, device=dev).reshape(C, T, 1, 1) * cells
    acc = torch.zeros(C * T * cells, dtype=torch.int32, device=dev)
    acc.index_add_(0, (cell + base).reshape(-1), bins.strong.reshape(-1).to(torch.int32))
    return acc.reshape(C, T, N_THETA, N_RHO).to(torch.float32)


def accumulator_peaks(acc: torch.Tensor, k: int):
    """3x3 accumulator NMS scored by the 3x3 vote sum (zero outside the
    accumulator), then each tile's k best: (votes [C, T, k], theta bin,
    rho bin)."""
    C, T = acc.shape[:2]
    pad = torch.nn.functional.pad(acc, (1, 1, 1, 1))
    mx = acc
    acc3 = acc
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            sl = pad[..., 1 + dy:1 + dy + N_THETA, 1 + dx:1 + dx + N_RHO]
            mx = torch.maximum(mx, sl)
            acc3 = acc3 + sl
    peaks = torch.where(acc >= mx, acc3, torch.zeros_like(acc3)).reshape(C, T, -1)
    votes, flat = _top_k(peaks, k)
    return votes, flat // N_RHO, flat % N_RHO


def _line_extents(strong, theta, cos_p, sin_p, rho_p, tc_p):
    """Longest run of occupied bins along each peak's line: (s_min, s_max,
    has) [c, T, K] for strong / theta [c, T, TH, TW] and the peaks' line
    parameters [c, T, K]."""
    c, T, K = cos_p.shape
    dev = strong.device
    xs = torch.arange(TILE_W, dtype=torch.float32, device=dev)
    ys = torch.arange(TILE_H, dtype=torch.float32, device=dev)[:, None]
    co, sn, r, tc = (a[..., None, None] for a in (cos_p, sin_p, rho_p, tc_p))
    d = xs * co + ys * sn - r                                      # [c, T, K, TH, TW]
    dth = torch.abs(theta[:, :, None] - tc)
    ang_ok = torch.minimum(dth, math.pi - dth) < ANGLE_TOL
    inlier = strong[:, :, None] & (torch.abs(d) < 1.5 * RHO_BIN) & ang_ok
    # tangent direction (-sin, cos): parameter s = -x sin + y cos
    s = -xs * sn + ys * co
    sb = torch.clamp(((s + TILE_DIAG) * S_SCALE).to(torch.int32), 0, SBINS - 1)
    n = c * T * K
    occ = torch.zeros((n, SBINS), dtype=torch.int32, device=dev).scatter_add_(
        1, sb.reshape(n, -1).long(), inlier.reshape(n, -1).to(torch.int32)) > 0
    occ_d = occ
    for _ in range(2):       # close gaps of up to 2 bins (about 6 px)
        occ_d = occ_d | torch.roll(occ_d, 1, -1) | torch.roll(occ_d, -1, -1)
    grp = torch.cumsum((~occ_d).to(torch.int64), -1)               # run id per bin
    cnt = torch.zeros((n, SBINS + 1), dtype=torch.int32, device=dev).scatter_add_(
        1, grp, occ.to(torch.int32))
    best = torch.argmax(cnt, -1, keepdim=True)
    in_best = occ & (grp == best)
    bins = torch.arange(SBINS, device=dev)
    lo = torch.where(in_best, bins, SBINS).amin(-1)
    hi = torch.where(in_best, bins, -1).amax(-1)
    s_min = lo.to(torch.float32) / S_SCALE - TILE_DIAG
    s_max = (hi.to(torch.float32) + 1.0) / S_SCALE - TILE_DIAG
    has = cnt.gather(1, best)[:, 0] > 0
    return s_min.reshape(c, T, K), s_max.reshape(c, T, K), has.reshape(c, T, K)


def peak_segments(bins: HoughBins, votes, pk_t, pk_r, max_lines: int, min_votes: int = 40,
                  min_len: float = 30.0):
    """The peaks' segments in image coordinates and the frame's strongest
    ``max_lines`` of them: (segments [C, max_lines, 4] (x1, y1, x2, y2),
    valid [C, max_lines])."""
    C, T = votes.shape[:2]
    dev = votes.device
    tc = _theta_centers(dev)
    cos_p, sin_p, tc_p = torch.cos(tc)[pk_t], torch.sin(tc)[pk_t], tc[pk_t]
    rho_p = (pk_r.to(torch.float32) + 0.5) * RHO_BIN - TILE_DIAG
    step = FRAMES_PER_PASS
    parts = [_line_extents(bins.strong[lo:lo + step], bins.theta[lo:lo + step],
                           *(a[lo:lo + step] for a in (cos_p, sin_p, rho_p, tc_p)))
             for lo in range(0, C, step)]
    s_min, s_max, has = (torch.cat(x) for x in zip(*parts))
    length = torch.where(has, s_max - s_min, torch.zeros_like(s_max))
    line_ok = (votes >= min_votes) & has & (length >= min_len)

    tiles = torch.arange(T, device=dev)
    x0 = ((tiles % bins.ntx) * TILE_W).to(torch.float32)[:, None]
    y0 = ((tiles // bins.ntx) * TILE_H).to(torch.float32)[:, None]
    x1 = rho_p * cos_p - s_min * sin_p + x0
    y1 = rho_p * sin_p + s_min * cos_p + y0
    x2 = rho_p * cos_p - s_max * sin_p + x0
    y2 = rho_p * sin_p + s_max * cos_p + y0
    segs_all = torch.stack([x1, y1, x2, y2], -1).reshape(C, -1, 4)
    score = torch.where(line_ok, votes, torch.full_like(votes, -1.0)).reshape(C, -1)
    top_v, top_i = _top_k(score, max_lines)
    segs = torch.gather(segs_all, 1, top_i[..., None].expand(-1, -1, 4))
    return segs, top_v > 0.0


def detect_segments(img: torch.Tensor, max_lines: int = 64, grad_thresh: float = 40.0,
                    min_votes: int = 40, min_len: float = 30.0):
    """Grayscale [H, W] or a batch [C, H, W] (float, 0..255) -> (segments
    [.., max_lines, 4] (x1, y1, x2, y2), valid [.., max_lines]). A frame
    keeps K = max(2, max_lines // tiles + 2) peaks per tile before the final
    selection. An edge that crosses a tile seam comes out as two segments
    (``merge_collinear`` removes such duplicates; this function does
    not)."""
    single = img.dim() == 2
    x = (img[None] if single else img).to(torch.float32)
    bins = hough_bins(x, grad_thresh)
    K = max(2, max_lines // bins.t_bin.shape[1] + 2)
    votes, pk_t, pk_r = accumulator_peaks(vote_accumulator(bins), K)
    segs, valid = peak_segments(bins, votes, pk_t, pk_r, max_lines, min_votes, min_len)
    return (segs[0], valid[0]) if single else (segs, valid)


def merge_collinear(segs: torch.Tensor, valid: torch.Tensor, angle_tol_deg: float = 5.0,
                    dist_tol: float = 20.0):
    """Drop collinear duplicates ([.., L, 4], [.., L]): a valid segment
    within ``angle_tol_deg`` of a strictly longer valid one, whose midpoint
    lies within 4 px of its line, with the two midpoints closer than their
    mean length plus ``dist_tol``, is invalidated; the survivor keeps
    its own endpoints. Returns (segs, keep)."""
    d = segs[..., 2:] - segs[..., :2]
    length = torch.linalg.norm(d, dim=-1)
    ang = torch.atan2(d[..., 1], d[..., 0])
    da = torch.abs(torch.remainder(ang[..., :, None] - ang[..., None, :] + math.pi / 2, math.pi)
                   - math.pi / 2)
    mid = 0.5 * (segs[..., :2] + segs[..., 2:])
    nrm = torch.stack([-d[..., 1], d[..., 0]], -1) / torch.clamp(length, min=1e-6)[..., None]
    # off[i, j]: distance of segment i's midpoint from segment j's line
    off = torch.abs((nrm[..., None, :, :] * (mid[..., :, None, :] - segs[..., None, :, :2])).sum(-1))
    tol = float(np.float32(angle_tol_deg) * np.float32(np.pi / 180))
    gap = torch.linalg.norm(mid[..., :, None, :] - mid[..., None, :, :], dim=-1)
    mergeable = (valid[..., :, None] & valid[..., None, :] & (da < tol)
                 & (off.transpose(-1, -2) < 4.0)
                 & (gap < (length[..., :, None] + length[..., None, :]) / 2 + dist_tol))
    absorbed = mergeable & (length[..., :, None] < length[..., None, :])
    return segs, valid & ~absorbed.any(-1)
