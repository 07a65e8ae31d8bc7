"""Descriptor matching as dense masked matrix ops.

Every regime is: full hamming matrix -> feasibility mask -> row-wise best
and second best -> ratio, threshold and rotation-consistency gates ->
one row per matched column. Descriptors are [N, 8] int32 holding the
uint32 bit pattern; every integer output is bit-exact with the reference.
"""

from __future__ import annotations

import math

import torch

TH_LOW = 50
TH_HIGH = 100
HISTO_BINS = 30
BIG = 1 << 20
_MASKED = 300  # sentinel distance: behaves like +inf, keeps packed keys in int32

_M1 = 0x5555555555555555
_M2 = 0x3333333333333333
_M4 = 0x0F0F0F0F0F0F0F0F


def popcount64(v: torch.Tensor) -> torch.Tensor:
    """Population count of int64 bit patterns (SWAR). The masks drop the
    bits an arithmetic right shift smears in, and after the nibble step the
    value is non-negative, so no step overflows."""
    v = v - ((v >> 1) & _M1)
    v = (v & _M2) + ((v >> 2) & _M2)
    v = (v + (v >> 4)) & _M4
    v = v + (v >> 8)
    v = v + (v >> 16)
    v = v + (v >> 32)
    return v & 0x7F


def hamming_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[N, 8] x [M, 8] int32 descriptors -> [N, M] int32 distances: XOR and
    popcount over the descriptors viewed as four 64-bit words."""
    a64 = a.contiguous().view(torch.int64)
    b64 = b.contiguous().view(torch.int64)
    acc = popcount64(a64[:, None, 0] ^ b64[None, :, 0])
    for w in range(1, a64.shape[1]):
        acc = acc + popcount64(a64[:, None, w] ^ b64[None, :, w])
    return acc.to(torch.int32)


def best_two(dist: torch.Tensor, mask: torch.Tensor):
    """Row-wise best index/distance and second-best distance over the mask
    (packed ``dist << shift | col`` min, ties to the lowest column)."""
    M = dist.shape[1]
    shift = max(int(M - 1).bit_length(), 1)
    assert (_MASKED << shift) < (1 << 31), "column count too large for packed min"
    cols = torch.arange(M, dtype=torch.int32, device=dist.device)
    key = (torch.where(mask, dist, _MASKED) << shift) | cols[None, :]
    p1 = key.amin(1)
    best = p1 >> shift
    best_idx = p1 & ((1 << shift) - 1)
    key2 = torch.where(cols[None, :] == best_idx[:, None],
                       (_MASKED << shift) | cols[None, :], key)
    second = key2.amin(1) >> shift
    return best_idx, best, second


def match_nn(dist, mask, max_dist: int = TH_LOW, ratio: float = 1.0,
             mutual: bool = False):
    """Nearest neighbour with threshold, Lowe ratio and optional mutual
    check. Returns (idx [N] int32, dist [N] int32, ok [N] bool)."""
    best_idx, best, second = best_two(dist, mask)
    ok = (best <= max_dist) & (best.float() <= ratio * second.float())
    if mutual:
        N = dist.shape[0]
        shift = max(int(N - 1).bit_length(), 1)
        rows = torch.arange(N, dtype=torch.int32, device=dist.device)
        key = (torch.where(mask, dist, _MASKED) << shift) | rows[:, None]
        col_best = key.amin(0) & ((1 << shift) - 1)
        ok = ok & (col_best[best_idx.long()] == rows)
    return best_idx.to(torch.int32), best, ok


def resolve_duplicate_cols(idx, dist, ok, n_cols: int):
    """Keep only the lowest-distance row per matched column, ties to the
    lowest row."""
    i = idx.long()
    key = torch.where(ok, dist, BIG)
    col_min = torch.full((n_cols,), BIG, dtype=key.dtype, device=key.device)
    col_min = col_min.scatter_reduce(0, i, key, "amin")
    keep = ok & (key == col_min[i])
    row_ids = torch.arange(idx.shape[0], dtype=torch.int32, device=idx.device)
    big = 1 << 30
    col_row = torch.full((n_cols,), big, dtype=torch.int32, device=idx.device)
    col_row = col_row.scatter_reduce(0, i, torch.where(keep, row_ids, big), "amin")
    return keep & (col_row[i] == row_ids)


def rotation_consistency(angle_q, angle_t, idx, ok, bins: int = HISTO_BINS,
                         keep_top: int = 3):
    """Keep matches whose relative rotation falls in the 3 dominant
    histogram bins, and only bins above 10% of the best (ties in bin count
    rank the lower bin first, as ``jax.lax.top_k`` does)."""
    rot = angle_q - angle_t[idx.long()]
    two_pi = 2.0 * math.pi
    rot = torch.remainder(rot, two_pi)
    bin_idx = torch.clamp((rot * bins / two_pi).to(torch.int32), 0, bins - 1).long()
    hist = torch.zeros(bins, dtype=torch.int32, device=ok.device)
    hist = hist.index_add(0, bin_idx, ok.to(torch.int32))
    top_vals, top_bins = torch.sort(hist, descending=True, stable=True)
    top_vals, top_bins = top_vals[:keep_top], top_bins[:keep_top]
    thr = torch.clamp((0.1 * top_vals[0].float()).to(torch.int32), min=1)
    good_bin = torch.zeros(bins, dtype=torch.bool, device=ok.device)
    good_bin[top_bins] = top_vals > thr
    return ok & good_bin[bin_idx]


# ---------------------------------------------------------------------------
# feasibility masks
# ---------------------------------------------------------------------------

def window_mask(proj_uv, kp, radius, query_valid, train_valid):
    """|kp - proj| <= radius per query (both axes)."""
    r = torch.as_tensor(radius, dtype=torch.float32, device=proj_uv.device)
    r = r.expand(proj_uv.shape[0])
    d = torch.abs(proj_uv[:, None, :] - kp[None, :, :])
    inside = (d[..., 0] <= r[:, None]) & (d[..., 1] <= r[:, None])
    return inside & query_valid[:, None] & train_valid[None, :]


def octave_mask(pred_octave, kp_octave, lo: int = 0, hi: int = 1):
    d = kp_octave[None, :] - pred_octave[:, None]
    return (d >= -lo) & (d <= hi)


def epipolar_mask(F12, kp1, kp2, sigma2_kp2, chi2: float = 3.84):
    ones1 = torch.ones((kp1.shape[0], 1), dtype=kp1.dtype, device=kp1.device)
    x1 = torch.cat([kp1, ones1], 1)
    lines = x1 @ F12
    a, b, c = lines[:, 0:1], lines[:, 1:2], lines[:, 2:3]
    num = a * kp2[None, :, 0] + b * kp2[None, :, 1] + c
    den = a * a + b * b
    dsq = (num * num) / torch.clamp(den, min=1e-12)
    return dsq < chi2 * sigma2_kp2[None, :]


def fundamental_from_poses(K, T1w, T2w):
    """F12 with x1^T F12 x2 = 0 from camera-from-world poses."""
    R1, t1 = T1w[:3, :3], T1w[:3, 3]
    R2, t2 = T2w[:3, :3], T2w[:3, 3]
    R12 = R1 @ R2.T
    t12 = -R12 @ t2 + t1
    z = torch.zeros((), dtype=K.dtype, device=K.device)
    tx = torch.stack([
        torch.stack([z, -t12[2], t12[1]]),
        torch.stack([t12[2], z, -t12[0]]),
        torch.stack([-t12[1], t12[0], z]),
    ])
    Kinv = torch.linalg.inv(K)
    return Kinv.T @ tx @ R12 @ Kinv


# ---------------------------------------------------------------------------
# composite regimes
# ---------------------------------------------------------------------------

def search_by_projection(proj_uv, pred_octave, query_desc, query_valid,
                         kp, kp_octave, kp_desc, kp_valid, radius,
                         query_angle=None, kp_angle=None,
                         max_dist: int = TH_HIGH, ratio: float = 0.9,
                         check_rotation: bool = False):
    dist = hamming_matrix(query_desc, kp_desc)
    mask = window_mask(proj_uv, kp, radius, query_valid, kp_valid)
    mask = mask & octave_mask(pred_octave, kp_octave)
    idx, d, ok = match_nn(dist, mask, max_dist=max_dist, ratio=ratio)
    if check_rotation and query_angle is not None:
        ok = rotation_consistency(query_angle, kp_angle, idx, ok)
    ok = resolve_duplicate_cols(idx, d, ok, kp.shape[0])
    return idx, d, ok


def search_for_initialization(kp1, desc1, angle1, valid1, kp2, desc2, angle2,
                              valid2, window: float = 100.0,
                              max_dist: int = TH_LOW, ratio: float = 0.9):
    dist = hamming_matrix(desc1, desc2)
    mask = window_mask(kp1, kp2, window, valid1, valid2)
    idx, d, ok = match_nn(dist, mask, max_dist=max_dist, ratio=ratio)
    ok = rotation_consistency(angle1, angle2, idx, ok)
    ok = resolve_duplicate_cols(idx, d, ok, kp2.shape[0])
    return idx, d, ok


def search_brute(desc1, valid1, desc2, valid2, max_dist: int = TH_LOW,
                 ratio: float = 0.75):
    dist = hamming_matrix(desc1, desc2)
    mask = valid1[:, None] & valid2[None, :]
    idx, d, ok = match_nn(dist, mask, max_dist=max_dist, ratio=ratio, mutual=True)
    ok = resolve_duplicate_cols(idx, d, ok, desc2.shape[0])
    return idx, d, ok


def search_for_triangulation(kp1, desc1, octave1, valid1, kp2, desc2, octave2,
                             valid2, F12, sigma2_by_octave, epi_center2,
                             min_epi_dist2, max_dist: int = TH_LOW):
    dist = hamming_matrix(desc1, desc2)
    sigma2_kp2 = sigma2_by_octave[octave2.long()]
    mask = valid1[:, None] & valid2[None, :]
    mask = mask & epipolar_mask(F12, kp1, kp2, sigma2_kp2)
    d_epi = ((kp2 - epi_center2[None, :]) ** 2).sum(-1)
    mask = mask & (d_epi > min_epi_dist2)[None, :]
    idx, d, ok = match_nn(dist, mask, max_dist=max_dist, ratio=1.0, mutual=True)
    ok = resolve_duplicate_cols(idx, d, ok, kp2.shape[0])
    return idx, d, ok
