"""Dense FAST-9/16 score + 3x3 non-max suppression + index packing.

Replaces the Pallas TPU kernel ``fast_nms_comb`` of the reference package
(eao_slam_tpu/ops/fast_pallas.py:83-94, body ``_kernel`` at :34-80) with
the hand-written CUDA kernel in ``csrc/fast_nms.cu``. One launch covers one
pyramid level of a whole chunk, ``[C, H, W]``.

Output per pixel: ``clip(score, 0, 1023) << 20 | (y * W + x)`` where
``score`` is the FAST-9/16 corner score kept only at 3x3 local maxima
(``score >= max of the 8 neighbours``) and zeroed within ``border`` of the
edge.

``fast_nms_comb_reference`` is the plain PyTorch version of the same
function, written from the reference's XLA formulation
(``pack_comb(nms3x3(fast_score(level)), border)``, eao_slam_tpu/ops/orb.py).
The wrapper takes it only for a tensor on the CPU; for a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import torch

# FAST-9/16 Bresenham ring of radius 3, clockwise from 12 o'clock, (dy, dx).
FAST_RING = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(os.path.dirname(_HERE), "csrc", "fast_nms.cu")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build", "eao_slam_torch")
LIBRARY = os.path.join(BUILD_DIR, "libfast_nms.so")

launches = 0          # kernel launches since the last reset (main-path count)

_lib = None
_lock = threading.Lock()


def reset_launches() -> None:
    global launches
    launches = 0


def nvcc_command(source: str = SOURCE, output: str = LIBRARY) -> list:
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(nvcc):
        nvcc = "nvcc"
    return [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
            "-shared", "-Xcompiler", "-fPIC", "-o", output, source]


def build(force: bool = False) -> str:
    """Compile csrc/fast_nms.cu into build/eao_slam_torch/libfast_nms.so
    (rebuilt when the source is newer than the library)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fresh = (os.path.exists(LIBRARY)
             and os.path.getmtime(LIBRARY) >= os.path.getmtime(SOURCE))
    if fresh and not force:
        return LIBRARY
    tmp = f"{LIBRARY}.{os.getpid()}.tmp"
    proc = subprocess.run(nvcc_command(SOURCE, tmp), capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed building {SOURCE}:\n{proc.stderr}")
    os.replace(tmp, LIBRARY)
    return LIBRARY


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.fast_nms_comb_launch.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ]
            lib.fast_nms_comb_launch.restype = ctypes.c_int
            _lib = lib
    return _lib


def fast_nms_comb(levels: torch.Tensor, border: int = 19) -> torch.Tensor:
    """[C, H, W] (or [H, W]) float32 integer-valued level images -> int32
    packed ``score << 20 | y*W + x`` maps of the same shape."""
    if levels.dtype != torch.float32:
        raise TypeError(f"fast_nms_comb takes float32, got {levels.dtype}")
    if levels.dim() not in (2, 3):
        raise ValueError(f"fast_nms_comb takes [H, W] or [C, H, W], got {tuple(levels.shape)}")
    H, W = levels.shape[-2:]
    if H * W >= (1 << 20) or H < 1 or W < 1:
        raise ValueError(f"level {H}x{W} does not fit the 20-bit packed index")
    if levels.device.type == "cpu":
        return fast_nms_comb_reference(levels, border)
    if levels.device.type != "cuda":
        raise ValueError(f"fast_nms_comb runs on cuda or cpu, got {levels.device}")
    if not levels.is_contiguous():
        raise ValueError("fast_nms_comb takes a contiguous tensor")
    lib = _load()
    out = torch.empty(levels.shape, dtype=torch.int32, device=levels.device)
    C = levels.shape[0] if levels.dim() == 3 else 1
    global launches
    with torch.cuda.device(levels.device):
        stream = torch.cuda.current_stream(levels.device).cuda_stream
        err = lib.fast_nms_comb_launch(levels.data_ptr(), out.data_ptr(), C, H, W,
                                       int(border), stream)
    if err != 0:
        raise RuntimeError(f"fast_nms_comb kernel launch failed: CUDA error {err}")
    launches += 1
    return out


# ---------------------------------------------------------------------------
# plain PyTorch version (the XLA formulation of the reference)
# ---------------------------------------------------------------------------

def _shifted(img: torch.Tensor, offsets, pad_value=None):
    """out[..., y, x] = img[..., y + dy, x + dx] with edge (or constant)
    padding, for each (dy, dx)."""
    H, W = img.shape[-2:]
    r_y = max(abs(dy) for dy, _ in offsets)
    r_x = max(abs(dx) for _, dx in offsets)
    lead = img.shape[:-2]
    x = img.reshape(-1, 1, H, W)
    if pad_value is None:
        p = torch.nn.functional.pad(x.float(), (r_x, r_x, r_y, r_y), mode="replicate").to(img.dtype)
    else:
        p = torch.nn.functional.pad(x, (r_x, r_x, r_y, r_y), value=pad_value)
    p = p.reshape(*lead, H + 2 * r_y, W + 2 * r_x)
    return [p[..., r_y + dy:r_y + dy + H, r_x + dx:r_x + dx + W] for dy, dx in offsets]


def fast_score(img: torch.Tensor) -> torch.Tensor:
    """Dense FAST-9/16 score: max over the bright and dark sides of the
    max over 16 start positions of the min over an arc of 9 ring
    differences. Integer arithmetic on the rounded level (exact)."""
    im = torch.round(img).to(torch.int32)
    ring = _shifted(im, FAST_RING)
    diff_b = [r - im for r in ring]
    diff_d = [im - r for r in ring]

    def arc9_max_min(d):
        e2 = [torch.minimum(d[i], d[(i + 1) % 16]) for i in range(16)]
        e4 = [torch.minimum(e2[i], e2[(i + 2) % 16]) for i in range(16)]
        e8 = [torch.minimum(e4[i], e4[(i + 4) % 16]) for i in range(16)]
        e9 = [torch.minimum(e8[i], d[(i + 8) % 16]) for i in range(16)]
        out = e9[0]
        for i in range(1, 16):
            out = torch.maximum(out, e9[i])
        return out

    return torch.maximum(arc9_max_min(diff_b), arc9_max_min(diff_d))


def nms3x3(score: torch.Tensor) -> torch.Tensor:
    """Keep 3x3 local maxima (score >= every neighbour), else 0; the
    outside of the image counts as -inf."""
    offs = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
    neigh = _shifted(score, offs, pad_value=torch.iinfo(torch.int32).min)
    mx = neigh[0]
    for s in neigh[1:]:
        mx = torch.maximum(mx, s)
    return torch.where(score >= mx, score, torch.zeros_like(score))


def pack_comb(score: torch.Tensor, border: int) -> torch.Tensor:
    h, w = score.shape[-2:]
    ys = torch.arange(h, device=score.device)[:, None]
    xs = torch.arange(w, device=score.device)[None, :]
    inb = (ys >= border) & (ys < h - border) & (xs >= border) & (xs < w - border)
    s = torch.where(inb, score, torch.zeros_like(score))
    idx = (ys * w + xs).to(torch.int32)
    return (torch.clamp(s, 0, 1023).to(torch.int32) << 20) | idx


def fast_nms_comb_reference(levels: torch.Tensor, border: int = 19) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device."""
    return pack_comb(nms3x3(fast_score(levels)), border)
