"""The import guard, and a run that finds no card."""

from __future__ import annotations

import os
import subprocess
import sys

import pytest
from conftest import BENCH, ROOT

from harness.check import forbidden_modules


def test_guard_compares_whole_top_level_names():
    mods = {"jax": 1, "jax.numpy": 1, "jaxlib.xla_client": 1, "flax.linen": 1,
            "eao_slam_tpu": 1, "eao_slam_tpu.ops.orb": 1, "eao_slam_torch": 1,
            "eao_slam_torch.ops": 1, "jaxtyping": 1, "jax_like": 1, "numpy": 1}
    assert forbidden_modules(mods) == ["eao_slam_tpu", "eao_slam_tpu.ops.orb", "flax.linen",
                                       "jax", "jax.numpy", "jaxlib.xla_client"]


def test_harness_reference_and_port_load_no_jax():
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "import harness.runner, harness.spec, reference.orb, eao_slam_torch.system\n"
            "from harness.check import forbidden_modules\n"
            "print(forbidden_modules())") % (BENCH, ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_reference_imports_nothing_of_the_program():
    src = open(os.path.join(BENCH, "reference", "orb.py")).read()
    assert "eao_slam" not in src and "jax" not in src.replace("JAX", "")


def test_a_run_without_a_card_fails_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card: the run would proceed")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "tum3_eao.chunked",
                          "--seed", "3000000007", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
