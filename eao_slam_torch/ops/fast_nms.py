"""Dense FAST-9/16 score + 3x3 non-max suppression + index packing, and
the per-cell maximum of the packed map.

Replaces the Pallas TPU kernel ``fast_nms_comb`` of the reference package
(eao_slam_tpu/ops/fast_pallas.py:83-94, body ``_kernel`` at :34-80) with
the hand-written CUDA kernel in ``csrc/fast_nms.cu``. One launch covers
every pyramid level of a whole chunk.

Per pixel the packed value is ``clip(score, 0, 1023) << 20 | (y * W + x)``
where ``score`` is the FAST-9/16 corner score kept only at 3x3 local maxima
(``score >= max of the 8 neighbours``) and zeroed within ``border`` of the
edge. Two entries over the one kernel body:

``fast_nms_comb``      the packed map itself, ``[C, H, W]`` int32 (the Pallas
                       kernel's contract);
``fast_nms_tile_max``  the maximum of the packed map over each ``cell x cell``
                       cell, ``[C, ceil(H / cell), ceil(W / cell)]`` int32,
                       without writing the map: all that the keypoint
                       selection (ops/orb.py) reads.

Levels hold integer grey levels as float32 (8-bit images and their rounded
pyramid; the kernel takes any integer 0..16383). ``fast_nms_comb_reference`` and
``fast_nms_tile_max_reference`` are the plain PyTorch versions, written from
the reference's XLA formulation (``pack_comb(nms3x3(fast_score(level)),
border)`` and the padded tile maximum of ``select_from_comb``,
eao_slam_tpu/ops/orb.py). The wrappers take them only for tensors on the
CPU; for CUDA tensors they launch the kernel or raise.
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

KERNEL_CELL = 16      # the cell size the kernel reduces over (FAST_CELL)
MAX_LEVELS = 16       # levels one launch can take (FAST_MAX_LEVELS)

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(os.path.dirname(_HERE), "csrc", "fast_nms.cu")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build", "eao_slam_torch")
LIBRARY = os.path.join(BUILD_DIR, "libfast_nms.so")

# kernel launches per entry since the last reset (main-path counts); one per
# launch, whatever the number of levels it covers
launches = {"fast_nms_comb": 0, "fast_nms_tile_max": 0}

_lib = None
_lock = threading.Lock()


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


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
            lib.fast_nms_launch.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ]
            lib.fast_nms_launch.restype = ctypes.c_int
            _lib = lib
    return _lib


def _check_levels(name: str, levels):
    """Validate one level tensor or a tuple of them; returns (the tuple,
    whether a single tensor came in)."""
    single = isinstance(levels, torch.Tensor)
    lvls = (levels,) if single else tuple(levels)
    if not lvls:
        raise ValueError(f"{name} takes at least one level")
    flat = single and lvls[0].dim() == 2
    for x in lvls:
        if x.dtype != torch.float32:
            raise TypeError(f"{name} takes float32, got {x.dtype}")
        if x.dim() != 3 and not (flat and x.dim() == 2):
            raise ValueError(f"{name} takes [C, H, W] levels (or one [H, W]), got {tuple(x.shape)}")
        H, W = x.shape[-2:]
        if H * W >= (1 << 20) or H < 1 or W < 1:
            raise ValueError(f"level {H}x{W} does not fit the 20-bit packed index")
        if x.device != lvls[0].device or x.shape[:-2] != lvls[0].shape[:-2]:
            raise ValueError(f"{name} takes levels of one chunk on one device")
    return lvls, single


def _launch(name: str, lvls, outs, border: int, tile_max: bool) -> None:
    dev = lvls[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, got {dev}")
    if len(lvls) > MAX_LEVELS:
        raise ValueError(f"{name} takes at most {MAX_LEVELS} levels in one call")
    if any(not x.is_contiguous() for x in lvls):
        raise ValueError(f"{name} takes contiguous tensors")
    lib = _load()
    n = len(lvls)
    ptrs = ctypes.c_void_p * n
    ints = ctypes.c_int * n
    C = lvls[0].shape[0] if lvls[0].dim() == 3 else 1
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fast_nms_launch(
            ptrs(*[x.data_ptr() for x in lvls]), ptrs(*[o.data_ptr() for o in outs]),
            ints(*[x.shape[-2] for x in lvls]), ints(*[x.shape[-1] for x in lvls]),
            n, C, int(border), int(tile_max), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    launches[name] += 1


def fast_nms_comb(levels, border: int = 19):
    """[C, H, W] (or [H, W]) float32 level images holding integers 0..16383 ->
    int32 packed ``score << 20 | y*W + x`` maps of the same shape. A tuple
    of levels of one chunk gives a tuple of maps, from one launch."""
    lvls, single = _check_levels("fast_nms_comb", levels)
    if lvls[0].device.type == "cpu":
        outs = tuple(fast_nms_comb_reference(x, border) for x in lvls)
    else:
        outs = tuple(torch.empty(x.shape, dtype=torch.int32, device=x.device) for x in lvls)
        _launch("fast_nms_comb", lvls, outs, border, False)
    return outs[0] if single else outs


def fast_nms_tile_max(levels, border: int = 19, cell: int = KERNEL_CELL):
    """[C, H, W] (or [H, W]) levels as for ``fast_nms_comb`` -> the maximum
    packed value of each ``cell x cell`` cell, int32 [C, ceil(H / cell),
    ceil(W / cell)], without the full map. A tuple of levels gives a tuple,
    from one launch. On a CUDA tensor ``cell`` must be 16."""
    lvls, single = _check_levels("fast_nms_tile_max", levels)
    if cell < 1:
        raise ValueError(f"cell must be positive, got {cell}")
    if lvls[0].device.type == "cpu":
        outs = tuple(fast_nms_tile_max_reference(x, border, cell) for x in lvls)
    else:
        if cell != KERNEL_CELL:
            raise ValueError(f"the kernel reduces over cells of {KERNEL_CELL}, got cell={cell}")
        outs = tuple(torch.empty((*x.shape[:-2], -(-x.shape[-2] // cell), -(-x.shape[-1] // cell)),
                                 dtype=torch.int32, device=x.device) for x in lvls)
        _launch("fast_nms_tile_max", lvls, outs, border, True)
    return outs[0] if single else outs


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


def tile_max(comb: torch.Tensor, cell: int) -> torch.Tensor:
    """[..., h, w] packed map -> [..., ceil(h / cell), ceil(w / cell)]: each
    cell's maximum, the map zero-padded to whole cells (every packed value
    is >= 0)."""
    h, w = comb.shape[-2:]
    ph = (cell - h % cell) % cell
    pw = (cell - w % cell) % cell
    sp = torch.nn.functional.pad(comb, (0, pw, 0, ph))
    H2, W2 = sp.shape[-2:]
    lead = sp.shape[:-2]
    m = sp.reshape(*lead, H2 // cell, cell, W2).amax(-2)
    return m.reshape(*lead, H2 // cell, W2 // cell, cell).amax(-1)


def fast_nms_tile_max_reference(levels: torch.Tensor, border: int = 19,
                                cell: int = KERNEL_CELL) -> torch.Tensor:
    """Plain PyTorch version of the tile-max entry, on any device."""
    return tile_max(fast_nms_comb_reference(levels, border), cell)
