"""Measures how many instructions of a class one SM of an NVIDIA GPU starts per clock.

    python3 tools/int_instr_rate.py

Builds int_instr_rate.cu (beside this file) with nvcc and times, with CUDA
events, the three-input and two-input two-lane 16-bit min/max the FAST
kernel is made of, 32-bit integer add, and float32 multiply-add for
comparison, at the maximum SM clock nvidia-smi reports. The bound of
eao_slam_torch/csrc/fast_nms.cu in chip_smoke.py rests on the min/max rate.
Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

CLASSES = ("min_max3_s16x2", "min_max_s16x2", "add_s32", "fma_f32")
THREADS, PER_ITER, ITERS = 256, 32, 2048      # as int_instr_rate.cu launches and unrolls


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("int_instr_rate: no CUDA device is available", file=sys.stderr)
        return 1
    import chip_smoke
    from eao_slam_torch.ops import fast_nms

    os.makedirs(fast_nms.BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(fast_nms.BUILD_DIR, "libint_instr_rate.so")
    proc = subprocess.run(
        fast_nms.nvcc_command(os.path.join(HERE, "int_instr_rate.cu"), lib_path),
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on int_instr_rate.cu:\n{proc.stderr}")
    lib = ctypes.CDLL(lib_path)
    lib.rate_launch.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = sms * 8
    out = torch.empty(blocks * THREADS, dtype=torch.int32, device="cuda")
    clock = chip_smoke.sm_clock_hz()
    rates = {}
    for op, name in enumerate(CLASSES):
        def launch(op=op):
            err = lib.rate_launch(op, out.data_ptr(), blocks, ITERS,
                                  torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"rate_launch failed: CUDA error {err}")
        ms = chip_smoke.cuda_ms(launch, iters=10)
        rates[name] = blocks * THREADS * PER_ITER * ITERS / (ms * 1e-3) / (sms * clock)
    card = chip_smoke.card_line()
    print(f"instructions per SM per clock at {clock / 1e6:.0f} MHz: "
          + ", ".join(f"{k} {v:.1f}" for k, v in rates.items()))
    print(card)
    print(json.dumps({"card": card, "sm_clock_mhz": clock / 1e6,
                      "instructions_per_sm_per_clock": rates}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
