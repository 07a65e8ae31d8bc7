"""The control on the card: the tiny chunked cell run with the program's
matrix products in TF32 and the reference computed in TF32 in the
program's place comes out as not correct through the front end's numbers
(the cells' own size is read with ``control.py``; PERF.md section 2).

    python -m pytest benchmark/tests -m cuda      # on a machine with a card
"""

from __future__ import annotations

import os
import sys
import time

import pytest
import torch

from harness.runner import run_cell
from harness.spec import Spec


@pytest.mark.cuda
def test_tf32_control_is_not_correct(bench_copy):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the control is TF32, which only a card has)")
    import eao_slam_torch.device

    root, _ = bench_copy
    spec = Spec(os.path.join(root, "BENCHMARK.json"), os.path.join(root, "benchmark"))
    pinned = eao_slam_torch.device.fp32_solvers
    try:
        res, lines = run_cell(spec, "tiny_eao.chunked_tiny", 3000000029, 5.0, False,
                              time.perf_counter(), control="tf32")
    finally:                      # the control swapped the port's pin in every module
        for mod in list(sys.modules.values()):
            if getattr(mod, "__name__", "").startswith("eao_slam_torch") and \
                    hasattr(mod, "fp32_solvers"):
                mod.fp32_solvers = pinned
        pinned()
    assert res["correct"] is False, lines
    assert res["checks"]["frontend_kp_diff"]["value"] > res["checks"]["frontend_kp_diff"]["limit"]
