"""The plain ORB front end the benchmark holds the port's against.

Plain PyTorch, written out here and importing nothing of the program: the
antialiased pyramid as two float32 weight matrices per level, rounded to
integer grey levels; the dense FAST-9/16 score, the 3x3 non-maximum
suppression and the packed ``score << 20 | y * w + x`` map in exact integer
arithmetic; the maximum of each 16 x 16 cell; the spatially uniform top-n of
the cell winners (strong corners above the FAST threshold first, ties to
the lower cell); the intensity-centroid angle and the steered BRIEF
descriptor from one 37 x 37 raw patch, through the sampling table with the
7 x 7 sigma-2 blur folded in, rounded to bfloat16 and widened back (the
table's stored precision; the product is float32).

The matrix products run with the same operand shapes as the program's, so
that on one device the float32 results carry the same bits: a chunk's
frames go through the pyramid together, one level's keypoints of all frames
through the BRIEF product together. ``tf32=True`` computes those products in
TF32, the precision below the float32 the port states (the control).
"""

from __future__ import annotations

import contextlib
import functools
import math

import numpy as np
import torch

PATCH_R = 15
PATCH = 2 * PATCH_R + 1
N_ROT_BINS = 15
BLUR_R = 3
GPATCH = PATCH + 2 * BLUR_R
CELL = 16
RING = ((-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1))


# ---------------------------------------------------------------------------
# pyramid
# ---------------------------------------------------------------------------

def level_sizes(height: int, width: int, n_levels: int, scale_factor: float):
    return [(int(round(height / scale_factor ** l)), int(round(width / scale_factor ** l)))
            for l in range(n_levels)]


def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """[in_size, out_size] triangle-filter weights, widened by 1 / scale when
    downsampling, normalised per output sample, in float32 arithmetic."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x)).astype(f32)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0)).astype(f32)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def pyramid(img: torch.Tensor, n_levels: int, scale_factor: float) -> list:
    sizes = level_sizes(img.shape[-2], img.shape[-1], n_levels, scale_factor)
    levels = [img]
    for l in range(1, n_levels):
        prev = levels[-1]
        wy = torch.from_numpy(resize_weights(prev.shape[-2], sizes[l][0])).to(prev.device)
        wx = torch.from_numpy(resize_weights(prev.shape[-1], sizes[l][1])).to(prev.device)
        levels.append(torch.round(wy.T @ prev @ wx))
    return levels


# ---------------------------------------------------------------------------
# FAST-9/16, NMS, packing, cell maximum (integer arithmetic, exact)
# ---------------------------------------------------------------------------

def _shifted(x: torch.Tensor, offsets, value=None):
    H, W = x.shape[-2:]
    ry = max(abs(dy) for dy, _ in offsets)
    rx = max(abs(dx) for _, dx in offsets)
    flat = x.reshape(-1, 1, H, W)
    if value is None:
        p = torch.nn.functional.pad(flat.float(), (rx, rx, ry, ry), mode="replicate").to(x.dtype)
    else:
        p = torch.nn.functional.pad(flat, (rx, rx, ry, ry), value=value)
    p = p.reshape(*x.shape[:-2], H + 2 * ry, W + 2 * rx)
    return [p[..., ry + dy:ry + dy + H, rx + dx:rx + dx + W] for dy, dx in offsets]


def fast_score(level: torch.Tensor) -> torch.Tensor:
    """Max over the bright and dark side of the max over the 16 starts of
    the min of 9 consecutive ring differences."""
    c = torch.round(level).to(torch.int32)
    ring = _shifted(c, RING)

    def side(d):
        best = None
        for s in range(16):
            m = d[s]
            for k in range(1, 9):
                m = torch.minimum(m, d[(s + k) % 16])
            best = m if best is None else torch.maximum(best, m)
        return best

    return torch.maximum(side([r - c for r in ring]), side([c - r for r in ring]))


def packed_map(level: torch.Tensor, border: int) -> torch.Tensor:
    score = fast_score(level)
    neigh = _shifted(score, [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)],
                     value=torch.iinfo(torch.int32).min)
    mx = neigh[0]
    for s in neigh[1:]:
        mx = torch.maximum(mx, s)
    score = torch.where(score >= mx, score, torch.zeros_like(score))
    h, w = score.shape[-2:]
    ys = torch.arange(h, device=score.device)[:, None]
    xs = torch.arange(w, device=score.device)[None, :]
    inside = (ys >= border) & (ys < h - border) & (xs >= border) & (xs < w - border)
    score = torch.where(inside, score, torch.zeros_like(score))
    return (torch.clamp(score, 0, 1023).to(torch.int32) << 20) | (ys * w + xs).to(torch.int32)


def cell_max(packed: torch.Tensor, cell: int = CELL) -> torch.Tensor:
    h, w = packed.shape[-2:]
    p = torch.nn.functional.pad(packed, (0, (cell - w % cell) % cell, 0, (cell - h % cell) % cell))
    C, H2, W2 = p.shape
    return p.reshape(C, H2 // cell, cell, W2 // cell, cell).amax((2, 4))


def select(m: torch.Tensor, w: int, n_out: int, threshold: float, min_threshold: float):
    """Top n_out cell winners: (yx [C, n, 2] int64, valid [C, n])."""
    C = m.shape[0]
    m = m.reshape(C, -1)
    score = (m >> 20).to(torch.float32)
    pos = m & ((1 << 20) - 1)
    rank = torch.where(score >= threshold, score + 1e4,
                       torch.where(score >= min_threshold, score, torch.full_like(score, -1.0)))
    k = min(n_out, m.shape[1])
    top, order = torch.sort(rank, dim=1, descending=True, stable=True)
    pos = torch.gather(pos, 1, order[:, :k]).long()
    yx = torch.stack([pos // w, pos % w], -1)
    valid = top[:, :k] > 0.0
    if k < n_out:
        yx = torch.cat([yx, yx.new_zeros((C, n_out - k, 2))], 1)
        valid = torch.cat([valid, valid.new_zeros((C, n_out - k))], 1)
    return yx, valid


def per_level_counts(n_features: int, n_levels: int, scale_factor: float) -> list:
    f = 1.0 / scale_factor
    base = n_features * (1 - f) / (1 - f ** n_levels)
    counts = [int(round(base * f ** l)) for l in range(n_levels - 1)]
    counts.append(max(n_features - sum(counts), 8))
    return counts


# ---------------------------------------------------------------------------
# angle and steered BRIEF
# ---------------------------------------------------------------------------

def brief_pattern(seed: int = 8017, n_bits: int = 256, radius: int = 13) -> np.ndarray:
    rng = np.random.default_rng(seed)
    pts = []
    while len(pts) < 2 * n_bits:
        p = rng.normal(0.0, radius / 2.5, 2)
        if p @ p <= radius * radius:
            pts.append(p)
    pts = np.asarray(pts)
    return np.concatenate([pts[:n_bits], pts[n_bits:]], 1).astype(np.float32)


def _gauss(sigma: float, r: int) -> np.ndarray:
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


@functools.lru_cache(maxsize=1)
def brief_table() -> np.ndarray:
    """[37 * 37, 2 * 15 * 256]: bilinear weights of every bit's difference
    v2 - v1 at each of the 15 bin-centre rotations, then their derivative in
    the angle, over the 31 x 31 patch; the blur folded in over 37 x 37."""
    pat = brief_pattern()
    Q = N_ROT_BINS
    mat = np.zeros((PATCH * PATCH, 2 * Q * 256), np.float32)

    def scatter(col, py, px, sign, d_dpy=None, d_dpx=None):
        y0 = min(max(int(np.floor(py)), 0), PATCH - 2)
        x0 = min(max(int(np.floor(px)), 0), PATCH - 2)
        fy = min(max(py - y0, 0.0), 1.0)
        fx = min(max(px - x0, 0.0), 1.0)
        if d_dpy is None:
            w = ((1 - fy) * (1 - fx), fy * (1 - fx), (1 - fy) * fx, fy * fx)
        else:
            w = (-(1 - fx) * d_dpy - (1 - fy) * d_dpx, +(1 - fx) * d_dpy - fy * d_dpx,
                 -fx * d_dpy + (1 - fy) * d_dpx, +fx * d_dpy + fy * d_dpx)
        for (yy, xx), wi in zip(((y0, x0), (y0 + 1, x0), (y0, x0 + 1), (y0 + 1, x0 + 1)), w):
            mat[yy * PATCH + xx, col] += sign * wi

    for q in range(Q):
        a = 2.0 * np.pi * q / Q
        c, s = np.cos(a), np.sin(a)
        for k in range(256):
            y1, x1, y2, x2 = pat[k]
            for sign, yy, xx in ((-1.0, y1, x1), (1.0, y2, x2)):
                ry, rx = xx * s + yy * c, xx * c - yy * s
                scatter(q * 256 + k, ry + PATCH_R, rx + PATCH_R, sign)
                scatter(Q * 256 + q * 256 + k, ry + PATCH_R, rx + PATCH_R, sign,
                        d_dpy=rx, d_dpx=-ry)
    g = _gauss(2.0, BLUR_R).astype(np.float64)
    src = mat.reshape(PATCH, PATCH, -1).astype(np.float64)
    out = np.zeros((GPATCH, GPATCH, src.shape[-1]), np.float64)
    for dy in range(2 * BLUR_R + 1):
        for dx in range(2 * BLUR_R + 1):
            out[dy:dy + PATCH, dx:dx + PATCH] += g[dy] * g[dx] * src
    return out.reshape(GPATCH * GPATCH, -1).astype(np.float32)


def fast_atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    ax, ay = torch.abs(x), torch.abs(y)
    z = torch.minimum(ax, ay) / torch.clamp(torch.maximum(ax, ay), min=1e-20)
    z2 = z * z
    a = z * (0.9998660 + z2 * (-0.3302995 + z2 * (0.1801410 + z2 * (-0.0851330 + z2 * 0.0208351))))
    a = torch.where(ay > ax, 1.5707963 - a, a)
    a = torch.where(x < 0, 3.14159265 - a, a)
    return torch.where(y < 0, -a, a)


def describe(level: torch.Tensor, yx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """[C, H, W] level, [C, N, 2] centres -> [C, N, 8] int32 descriptors."""
    C, H, W = level.shape
    N = yx.shape[1]
    r = PATCH_R + BLUR_R
    padded = torch.nn.functional.pad(level, (r, r, r, r))
    offs = torch.arange(2 * r + 1, device=level.device)
    rows = (yx[..., 0:1] + offs).clamp(0, H + 2 * r - 1)
    cols = (yx[..., 1:2] + offs).clamp(0, W + 2 * r - 1)
    b = torch.arange(C, device=level.device)[:, None, None, None]
    raw = padded[b, rows[..., :, None], cols[..., None, :]]
    centre = raw[..., BLUR_R:BLUR_R + PATCH, BLUR_R:BLUR_R + PATCH]
    ys, xs = np.mgrid[-PATCH_R:PATCH_R + 1, -PATCH_R:PATCH_R + 1]
    disc = (ys * ys + xs * xs) <= PATCH_R * PATCH_R
    wx = torch.from_numpy((xs * disc).astype(np.float32)).to(level.device)
    wy = torch.from_numpy((ys * disc).astype(np.float32)).to(level.device)
    angle = fast_atan2((centre * wy).sum((-1, -2)), (centre * wx).sum((-1, -2))).reshape(-1)
    diffs = raw.reshape(C * N, GPATCH * GPATCH) @ table
    Q = N_ROT_BINS
    binw = 2.0 * math.pi / Q
    qreal = angle / binw
    qidx = torch.round(qreal)
    dtheta = (qreal - qidx) * binw
    sel = torch.remainder(qidx, Q).to(torch.int64)[:, None, None].expand(-1, 1, 256)
    base = torch.gather(diffs[:, :Q * 256].reshape(-1, Q, 256), 1, sel)[:, 0]
    deriv = torch.gather(diffs[:, Q * 256:].reshape(-1, Q, 256), 1, sel)[:, 0]
    bits = (base + dtheta[:, None] * deriv) > 0.0
    v = (bits.reshape(-1, 8, 32).to(torch.int64)
         << torch.arange(32, device=level.device, dtype=torch.int64)).sum(-1)
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32).reshape(C, N, 8)


@contextlib.contextmanager
def _precision(tf32: bool):
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def extract(images_u8: torch.Tensor, n_features: int, n_levels: int, scale_factor: float,
            threshold: float, min_threshold: float, border: int, tf32: bool = False,
            fast_block: int = 8) -> dict:
    """ORB features of a batch of images [C, H, W] uint8: per level, the
    selected centres ``yx`` [C, n_l, 2] (level pixels), ``valid`` [C, n_l]
    and ``desc`` [C, n_l, 8] int32. FAST runs ``fast_block`` frames at a
    time (integer arithmetic: the blocking changes no bit)."""
    table = torch.from_numpy(brief_table()).to(torch.bfloat16).to(torch.float32)
    table = table.to(images_u8.device)
    out = []
    with _precision(tf32), torch.no_grad():
        levels = pyramid(images_u8.to(torch.float32), n_levels, scale_factor)
        for lvl, n_l in zip(levels, per_level_counts(n_features, n_levels, scale_factor)):
            lvl = lvl.contiguous()
            m = torch.cat([cell_max(packed_map(lvl[i:i + fast_block], border))
                           for i in range(0, lvl.shape[0], fast_block)])
            yx, valid = select(m, lvl.shape[-1], n_l, threshold, min_threshold)
            out.append({"yx": yx.cpu().numpy(), "valid": valid.cpu().numpy(),
                        "desc": describe(lvl, yx, table).cpu().numpy()})
    return out
