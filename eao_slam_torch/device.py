"""Device selection and fp32 numerics for the port."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default, the CPU only
    when the caller asks for it. Never falls back silently."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev


def fp32_solvers() -> None:
    """Keep matrix products in full float32. TF32 keeps ~3 decimal digits,
    which measurably degrades the LM / BA solves."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
