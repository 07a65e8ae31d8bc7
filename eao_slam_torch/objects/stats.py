"""Statistical tests of the ensemble association, vectorized.

- Wilcoxon rank-sum band check over masked sample pairs (the reference's
  NoParaDataAssociation, src/Object.cc:714-930): the O(m n) comparison loop
  is a broadcast sign sum. Pair counts are summed in float32, exact up to
  2^24 (at most 128 x 192 pairs here).
- One-sample t statistic of a detection centroid against an object's
  centroid history (src/Object.cc:447-537) and the two-sample t of map
  object merges (src/Object.cc:1659-1712).
- Box-plot (IQR) depth outlier rejection (src/Object.cc:106-158).
"""

from __future__ import annotations

import numpy as np
import torch

RANK_SUM_BAND = 1.282  # 80 % two-sided band on W (src/Object.cc:904)


def rank_sum_statistic(a, a_mask, b, b_mask):
    """Per-axis Wilcoxon W for batched masked samples. a: [..., M, D],
    b: [..., N, D], masks [..., M] / [..., N]. Returns (w [..., D], m [...],
    n [...]): W = min(w12 + m(m+1)/2, w21 + n(n+1)/2) + ties / 2."""
    am = a_mask[..., :, None].to(torch.float32)
    bm = b_mask[..., :, None].to(torch.float32)
    pair = am[..., :, None, :] * bm[..., None, :, :]          # [..., M, N, 1]
    x, y = a[..., :, None, :], b[..., None, :, :]
    w12 = ((x > y).to(torch.float32) * pair).sum((-3, -2))
    w21 = ((x < y).to(torch.float32) * pair).sum((-3, -2))
    w00 = ((x == y).to(torch.float32) * pair).sum((-3, -2))
    m = a_mask.sum(-1).to(torch.float32)
    n = b_mask.sum(-1).to(torch.float32)
    w = torch.minimum(w12 + (m * (m + 1) / 2)[..., None],
                      w21 + (n * (n + 1) / 2)[..., None]) + w00 / 2
    return w, m, n


def rank_sum_all_axes_pass(a, a_mask, b, b_mask, band: float = RANK_SUM_BAND):
    """True where every axis's W lies strictly inside the normal band
    mean(W) +- band * sigma(W)."""
    w, m, n = rank_sum_statistic(a, a_mask, b, b_mask)
    mean = 0.5 * m * (m + n + 1)
    sigma = torch.sqrt(torch.clamp(m * n * (m + n + 1) / 12.0, min=1e-9))
    lo = (mean - band * sigma)[..., None]
    hi = (mean + band * sigma)[..., None]
    return ((w > lo) & (w < hi)).all(-1)


def t_statistic_center(det_center, obj_center, obj_center_std, df):
    """Per-axis one-sample t: |c_det - c_obj| / (s / sqrt(df)).
    det_center [..., 3], obj_center [..., 3], obj_center_std [..., 3],
    df [...] -> [..., 3]."""
    denom = obj_center_std / torch.sqrt(torch.clamp(df, min=1.0))[..., None]
    return (det_center - obj_center).abs() / torch.clamp(denom, min=1e-9)


def two_sample_t_statistic(mean1, std1, n1, mean2, std2, n2):
    """Pooled-variance two-sample t per axis."""
    n1 = torch.clamp(n1, min=2.0)
    n2 = torch.clamp(n2, min=2.0)
    sp2 = ((n1 - 1)[..., None] * std1 ** 2 + (n2 - 1)[..., None] * std2 ** 2) / (
        n1 + n2 - 2)[..., None]
    denom = torch.sqrt(torch.clamp(sp2 * (1.0 / n1 + 1.0 / n2)[..., None], min=1e-12))
    return (mean1 - mean2).abs() / denom


def make_t_table() -> np.ndarray:
    """[122, 9] t critical values in data/t_test.txt's layout (row = degrees
    of freedom, column 5 = alpha 0.05, column 8 = alpha 0.001), built on
    the host; callers move it to their device once."""
    from eao_slam_torch.io.tum import load_t_table

    return load_t_table(None)


def boxplot_depth_inliers(z, mask, k: float = 1.5):
    """IQR outlier mask on camera-frame depth: keep z in [Q1 - k IQR,
    Q3 + k IQR], quantiles by linear interpolation over the masked values.
    z, mask: [..., N] -> inlier mask [..., N]."""
    zs = torch.sort(torch.where(mask, z, torch.full_like(z, 1e9)), dim=-1).values
    n = mask.sum(-1)

    def quantile(q):
        idx = q * torch.clamp(n - 1, min=0).to(torch.float32)
        lo = torch.floor(idx).to(torch.int64)
        hi = torch.ceil(idx).to(torch.int64)
        frac = idx - lo.to(torch.float32)
        vlo = torch.gather(zs, -1, lo[..., None])[..., 0]
        vhi = torch.gather(zs, -1, hi[..., None])[..., 0]
        return vlo * (1 - frac) + vhi * frac

    q1, q3 = quantile(0.25), quantile(0.75)
    iqr = q3 - q1
    keep = (z >= (q1 - k * iqr)[..., None]) & (z <= (q3 + k * iqr)[..., None])
    return keep & mask
