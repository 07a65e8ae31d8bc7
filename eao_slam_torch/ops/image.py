"""Image-plane ops: the pyramid, Sobel gradients and the 3x3 maximum filter.

Pyramid: antialiased bilinear downsampling as two weight matrices. The
reference resizes with a triangle filter widened by 1/scale when
downsampling (jax.image.resize "bilinear", antialias on) and rounds every
level to integer grey levels. ``torch.nn.functional.interpolate`` does not
promise that filter, so the per-axis weight matrices are built here with
the same float32 formula and applied as ``Wy^T @ img @ Wx`` in full fp32.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


def level_sizes(height: int, width: int, n_levels: int, scale_factor: float):
    """Static (h, w) per pyramid level (cv::resize rounding)."""
    sizes = []
    for l in range(n_levels):
        s = 1.0 / (scale_factor ** l)
        sizes.append((int(round(height * s)), int(round(width * s))))
    return sizes


def gaussian_kernel1d(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


@lru_cache(maxsize=None)
def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """[in_size, out_size] float32 triangle-filter weights (antialiased on
    downsampling), column-normalised, in float32 arithmetic."""
    f32 = np.float32
    scale = out_size / in_size
    inv_scale = f32(1.0 / scale)
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x)).astype(f32)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0)).astype(f32)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def build_pyramid(img: torch.Tensor, n_levels: int = 8, scale_factor: float = 1.2):
    """[..., H, W] float32 -> tuple of per-level [..., h, w] images, each
    resized from the previous level and rounded to integers."""
    h, w = img.shape[-2:]
    sizes = level_sizes(h, w, n_levels, scale_factor)
    levels = [img]
    for l in range(1, n_levels):
        prev = levels[-1]
        ph, pw = prev.shape[-2:]
        wy = torch.from_numpy(resize_weights(ph, sizes[l][0])).to(prev.device)
        wx = torch.from_numpy(resize_weights(pw, sizes[l][1])).to(prev.device)
        levels.append(torch.round(wy.T @ prev @ wx))
    return tuple(levels)


def sobel_gradients(img: torch.Tensor):
    """[..., H, W] float32 -> (gx, gy, magnitude) of the 3x3 Sobel operator
    over the edge-padded image, summed in the reference's order."""
    H, W = img.shape[-2:]
    lead = img.shape[:-2]
    p = torch.nn.functional.pad(img.reshape(-1, 1, H, W), (1, 1, 1, 1), mode="replicate")
    p = p.reshape(*lead, H + 2, W + 2)

    def s(dy, dx):
        return p[..., 1 + dy:1 + dy + H, 1 + dx:1 + dx + W]

    gx = (s(-1, 1) + 2 * s(0, 1) + s(1, 1)) - (s(-1, -1) + 2 * s(0, -1) + s(1, -1))
    gy = (s(1, -1) + 2 * s(1, 0) + s(1, 1)) - (s(-1, -1) + 2 * s(-1, 0) + s(-1, 1))
    return gx, gy, torch.sqrt(gx * gx + gy * gy)


def max_filter3(m: torch.Tensor) -> torch.Tensor:
    """[H, W] -> the maximum over each pixel's 3x3 neighbourhood, zero
    outside the image (the reference's padded slice maxima; exact)."""
    H, W = m.shape
    p = torch.nn.functional.pad(m, (1, 1, 1, 1))
    out = m
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            out = torch.maximum(out, p[dy:dy + H, dx:dx + W])
    return out
