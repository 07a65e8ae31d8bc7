"""ORB feature extraction on batched tensors.

One launch of the dense FAST + NMS + packing kernel with the per-tile
maximum folded in (ops/fast_nms.py) covers all pyramid levels of a chunk;
then per level ``[C, H, W]``: spatially uniform per-tile top-k selection, the
intensity-centroid angle and continuously steered BRIEF from one raw
37x37 patch per keypoint. Same algorithm and constants as the reference
package's ops/orb.py; the BRIEF sampling table is regenerated from the same
seeded generator, never copied.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from eao_slam_torch.ops import image as image_ops
from eao_slam_torch.ops.fast_nms import fast_nms_tile_max, tile_max

PATCH_R = 15          # IC_Angle / BRIEF support radius (HALF_PATCH_SIZE)
PATCH = 2 * PATCH_R + 1
N_ROT_BINS = 15       # rotation bins of the steered pattern
_BLUR_R = 3           # 7x7 sigma-2 pre-descriptor blur radius
GPATCH = PATCH + 2 * _BLUR_R  # 37: raw patch with blur apron


def _make_brief_pattern(seed: int = 8017, n_bits: int = 256, radius: int = 13) -> np.ndarray:
    """Deterministic BRIEF pattern [n_bits, 4] = (y1, x1, y2, x2): Gaussian
    pairs (sigma = radius / 2.5) clipped to a disc of `radius`."""
    rng = np.random.default_rng(seed)
    pts = []
    while len(pts) < n_bits * 2:
        p = rng.normal(0.0, radius / 2.5, 2)
        if p @ p <= radius * radius:
            pts.append(p)
    pts = np.asarray(pts[: n_bits * 2])
    return np.concatenate([pts[:n_bits], pts[n_bits:]], axis=1).astype(np.float32)


BRIEF_PATTERN = _make_brief_pattern()


def _ic_angle_weights():
    ys, xs = np.mgrid[-PATCH_R: PATCH_R + 1, -PATCH_R: PATCH_R + 1]
    mask = (ys * ys + xs * xs) <= PATCH_R * PATCH_R
    return (xs * mask).astype(np.float32), (ys * mask).astype(np.float32)


def _brief_onehot() -> np.ndarray:
    """[31*31, 2*Q*256] bilinear sampling weights of every (bin, bit) pattern
    difference v2 - v1 at the Q bin-centre rotations (first Q*256 columns)
    and their derivative in the steering angle (last Q*256 columns)."""
    pat = BRIEF_PATTERN
    Q = N_ROT_BINS
    mat = np.zeros((PATCH * PATCH, 2 * Q * 256), np.float32)

    def scatter(col, py, px, sign, d_dpy=None, d_dpx=None):
        y0 = min(max(int(np.floor(py)), 0), PATCH - 2)
        x0 = min(max(int(np.floor(px)), 0), PATCH - 2)
        fy = min(max(py - y0, 0.0), 1.0)
        fx = min(max(px - x0, 0.0), 1.0)
        cells = ((y0, x0), (y0 + 1, x0), (y0, x0 + 1), (y0 + 1, x0 + 1))
        if d_dpy is None:
            w = ((1 - fy) * (1 - fx), fy * (1 - fx), (1 - fy) * fx, fy * fx)
        else:
            w = (
                -(1 - fx) * d_dpy - (1 - fy) * d_dpx,
                +(1 - fx) * d_dpy - fy * d_dpx,
                -fx * d_dpy + (1 - fy) * d_dpx,
                +fx * d_dpy + fy * d_dpx,
            )
        for (yy, xx), wi in zip(cells, w):
            mat[yy * PATCH + xx, col] += sign * wi

    for q in range(Q):
        a = 2.0 * np.pi * q / Q
        c, s = np.cos(a), np.sin(a)
        for k in range(256):
            y1, x1, y2, x2 = pat[k]
            for sign, yy, xx in ((-1.0, y1, x1), (1.0, y2, x2)):
                ry = xx * s + yy * c
                rx = xx * c - yy * s
                scatter(q * 256 + k, ry + PATCH_R, rx + PATCH_R, sign)
                scatter(Q * 256 + q * 256 + k, ry + PATCH_R, rx + PATCH_R,
                        sign, d_dpy=rx, d_dpx=-ry)
    return mat


def _brief_onehot_blurfolded() -> np.ndarray:
    """The sampling table over the RAW 37x37 patch with the 7x7 sigma-2
    pre-descriptor blur folded in (the blur is linear)."""
    mat31 = _brief_onehot()
    C = mat31.shape[1]
    k = image_ops.gaussian_kernel1d(2.0, _BLUR_R).astype(np.float64)
    src = mat31.reshape(PATCH, PATCH, C).astype(np.float64)
    out = np.zeros((GPATCH, GPATCH, C), np.float64)
    for dy in range(2 * _BLUR_R + 1):
        for dx in range(2 * _BLUR_R + 1):
            out[dy: dy + PATCH, dx: dx + PATCH, :] += k[dy] * k[dx] * src
    return out.reshape(GPATCH * GPATCH, C).astype(np.float32)


@lru_cache(maxsize=1)
def _brief_table_np() -> np.ndarray:
    return _brief_onehot_blurfolded()


@lru_cache(maxsize=None)
def _brief_table(device: torch.device) -> torch.Tensor:
    """The sampling table rounded to bfloat16 (as the reference stores it)
    and widened back to float32: the port multiplies in float32, so only
    the table's rounding is shared, not a bf16 product."""
    t = torch.from_numpy(_brief_table_np()).to(torch.bfloat16).to(torch.float32)
    return t.to(device)


@lru_cache(maxsize=None)
def _ic_weights(device: torch.device):
    wx, wy = _ic_angle_weights()
    return torch.from_numpy(wx).to(device), torch.from_numpy(wy).to(device)


def fast_atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Polynomial atan2 of the reference (max error ~1.2e-5 rad)."""
    ax, ay = torch.abs(x), torch.abs(y)
    mx, mn = torch.maximum(ax, ay), torch.minimum(ax, ay)
    z = mn / torch.clamp(mx, min=1e-20)
    z2 = z * z
    a = z * (0.9998660 + z2 * (-0.3302995 + z2 * (0.1801410 + z2 * (-0.0851330 + z2 * 0.0208351))))
    a = torch.where(ay > ax, 1.5707963 - a, a)
    a = torch.where(x < 0, 3.14159265 - a, a)
    return torch.where(y < 0, -a, a)


# ---------------------------------------------------------------------------
# per-tile keypoint selection
# ---------------------------------------------------------------------------

def select_from_comb(comb: torch.Tensor, n_out: int, threshold: float,
                     min_threshold: float, cell: int):
    """Spatially uniform top-n from packed ``score << 20 | idx`` maps
    [C, h, w]: each cell x cell tile's maximum (ops/fast_nms.tile_max), then
    ``select_from_tile_max``."""
    C, h, w = comb.shape
    assert h * w < (1 << 20)
    return select_from_tile_max(tile_max(comb, cell), w, n_out, threshold, min_threshold)


def select_from_tile_max(m: torch.Tensor, w: int, n_out: int, threshold: float,
                         min_threshold: float):
    """The global top-n of the tile winners ``m`` [C, th, tw] (each tile's
    maximum packed ``score << 20 | y * w + x`` of a level ``w`` wide), strong
    corners first. Ties rank the lower tile index first (a stable sort), as
    ``jax.lax.top_k`` does.

    Returns (yx [C, n_out, 2] int32, resp [C, n_out] f32, valid [C, n_out])."""
    C, th, tw = m.shape
    m = m.reshape(C, th * tw)
    tile_score = (m >> 20).to(torch.float32)
    tile_pos = m & ((1 << 20) - 1)
    rank = torch.where(
        tile_score >= threshold, tile_score + 1e4,
        torch.where(tile_score >= min_threshold, tile_score, torch.full_like(tile_score, -1.0)),
    )
    k = min(n_out, th * tw)
    top_rank, order = torch.sort(rank, dim=1, descending=True, stable=True)
    top_rank, top_idx = top_rank[:, :k], order[:, :k]
    pos = torch.gather(tile_pos, 1, top_idx)
    yx = torch.stack([pos // w, pos % w], -1).to(torch.int32)
    resp = torch.gather(tile_score, 1, top_idx)
    valid = top_rank > 0.0
    if k < n_out:
        pad = n_out - k
        yx = torch.cat([yx, yx.new_zeros((C, pad, 2))], 1)
        resp = torch.cat([resp, resp.new_zeros((C, pad))], 1)
        valid = torch.cat([valid, valid.new_zeros((C, pad))], 1)
    return yx, resp, valid


# ---------------------------------------------------------------------------
# orientation + descriptor
# ---------------------------------------------------------------------------

def gather_patches(img: torch.Tensor, yx: torch.Tensor, r: int) -> torch.Tensor:
    """[C, H, W] levels, [C, N, 2] integer centres -> [C, N, 2r+1, 2r+1]
    patches. Pixels outside the level read as 0, as the reference's one-hot
    selection gives; selected keypoints lie >= border >= r from the edge."""
    C, H, W = img.shape
    padded = torch.nn.functional.pad(img, (r, r, r, r))
    offs = torch.arange(2 * r + 1, device=img.device)
    rows = (yx[..., 0:1].long() + offs).clamp(0, H + 2 * r - 1)  # [C, N, d] (+r-r)
    cols = (yx[..., 1:2].long() + offs).clamp(0, W + 2 * r - 1)
    b = torch.arange(C, device=img.device)[:, None, None, None]
    return padded[b, rows[..., :, None], cols[..., None, :]]


def _angles_and_descriptors(img: torch.Tensor, yx: torch.Tensor):
    """IC angle and steered BRIEF from one raw 37x37 patch per keypoint.
    img [C, H, W] integer-valued; yx [C, N, 2]. Returns (angle [C, N],
    desc [C, N, 8] int32)."""
    C, N = yx.shape[:2]
    raw = gather_patches(img, yx, PATCH_R + _BLUR_R)             # [C, N, 37, 37]
    center = raw[..., _BLUR_R: _BLUR_R + PATCH, _BLUR_R: _BLUR_R + PATCH]
    wx, wy = _ic_weights(img.device)
    m10 = (center * wx).sum((-1, -2))
    m01 = (center * wy).sum((-1, -2))
    angles = fast_atan2(m01, m10)
    diffs_all = raw.reshape(C * N, GPATCH * GPATCH) @ _brief_table(img.device)
    desc = _steered_pack(diffs_all, angles.reshape(-1))
    return angles, desc.reshape(C, N, 8)


def _steered_pack(diffs_all: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Pick the angle bin, apply the first-order steering correction, pack
    256 bits -> [N, 8] int32 (the uint32 bit pattern of the reference)."""
    N = diffs_all.shape[0]
    Q = N_ROT_BINS
    binw = 2.0 * math.pi / Q
    qreal = angles / binw
    qidx = torch.round(qreal)
    dtheta = (qreal - qidx) * binw
    qbin = torch.remainder(qidx, Q).to(torch.int64)
    base = diffs_all[:, : Q * 256].reshape(N, Q, 256)
    deriv = diffs_all[:, Q * 256:].reshape(N, Q, 256)
    sel = qbin[:, None, None].expand(N, 1, 256)
    d = torch.gather(base, 1, sel)[:, 0] + dtheta[:, None] * torch.gather(deriv, 1, sel)[:, 0]
    return pack_bits(d > 0.0)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[N, 256] bool -> [N, 8] int32, bit b of word w = bits[32 w + b]."""
    shifts = torch.arange(32, device=bits.device, dtype=torch.int64)
    v = (bits.reshape(-1, 8, 32).to(torch.int64) << shifts).sum(-1)
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


# ---------------------------------------------------------------------------
# full extractor
# ---------------------------------------------------------------------------

class Features(NamedTuple):
    """Padded per-frame feature sets, level-0 pixel coordinates, [C, F, ...]."""

    kp: torch.Tensor        # [C, F, 2] float32 (x, y)
    desc: torch.Tensor      # [C, F, 8] int32 (uint32 bit pattern)
    octave: torch.Tensor    # [C, F] int32
    angle: torch.Tensor     # [C, F] float32 radians
    response: torch.Tensor  # [C, F] float32
    valid: torch.Tensor     # [C, F] bool


def per_level_counts(n_features: int, n_levels: int, scale_factor: float):
    factor = 1.0 / scale_factor
    base = n_features * (1 - factor) / (1 - factor ** n_levels)
    counts = [int(round(base * factor ** l)) for l in range(n_levels - 1)]
    counts.append(max(n_features - sum(counts), 8))
    return counts


def extract_orb(img: torch.Tensor, n_features: int = 1024, n_levels: int = 8,
                scale_factor: float = 1.2, threshold: float = 20.0,
                min_threshold: float = 7.0, border: int = 19, cell: int = 16,
                levels=None) -> Features:
    """ORB front end for a chunk of grayscale images [C, H, W] float32
    (0..255). ``levels`` optionally supplies a precomputed pyramid."""
    if levels is None:
        levels = image_ops.build_pyramid(img, n_levels, scale_factor)
    counts = per_level_counts(n_features, n_levels, scale_factor)
    C = levels[0].shape[0]
    out = {k: [] for k in Features._fields}
    levels = tuple(lvl.contiguous() for lvl in levels)
    tile_maxima = fast_nms_tile_max(levels, border=border, cell=cell)
    for l, lvl in enumerate(levels):
        n_l = counts[l]
        yx, resp, valid = select_from_tile_max(tile_maxima[l], lvl.shape[-1], n_l,
                                               threshold, min_threshold)
        ang, desc = _angles_and_descriptors(lvl, yx)
        scale = scale_factor ** l
        kp = torch.stack([yx[..., 1].float(), yx[..., 0].float()], -1) * scale
        out["kp"].append(kp)
        out["desc"].append(desc)
        out["octave"].append(torch.full((C, n_l), l, dtype=torch.int32, device=lvl.device))
        out["angle"].append(ang)
        out["response"].append(resp)
        out["valid"].append(valid)
    return Features(**{k: torch.cat(v, 1) for k, v in out.items()})


def scale_sigma2(n_levels: int = 8, scale_factor: float = 1.2, device=None) -> torch.Tensor:
    """Per-octave sigma^2 = (scale^l)^2 (mvLevelSigma2)."""
    return torch.tensor([(scale_factor ** l) ** 2 for l in range(n_levels)],
                        dtype=torch.float32, device=device)
