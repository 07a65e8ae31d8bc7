"""FAST-9/16 + 3x3 NMS + packing: the Pallas kernel (interpret mode), the
reference's XLA formulation, the port's plain PyTorch version and the
port's CUDA kernel all compute the same int32 map, bit for bit.

Trouble spot named here: edge semantics. The Pallas kernel runs its NMS on
an extended domain of the edge-padded image, the XLA path pads the score
with -inf; they differ only within 4 px of the edge, which border=19
masks. The port's kernel and plain version use -inf outside the image and
agree with each other for any border, and with both reference forms at
border=19, on every full-width level size (odd ones included)."""

import os
import shutil
import subprocess
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from eao_slam_tpu.ops import fast_pallas, orb as jorb
from eao_slam_torch.ops import fast_nms
from eao_slam_torch.ops.image import level_sizes
from torch_parity import n

LEVELS = level_sizes(480, 640, 8, 1.2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _levels(h, w, seed):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (2, h, w)).astype(np.float32)
    img[1] = np.round(img[1] / 64) * 64      # plateaus: exercises the >= tie rule
    return img


def _pallas(img, border=19):
    H, W = img.shape
    call = pl.pallas_call(partial(fast_pallas._kernel, H=H, W=W, border=border),
                          out_shape=jax.ShapeDtypeStruct((H, W), jnp.int32), interpret=True)
    return np.asarray(call(jnp.pad(jnp.asarray(img), fast_pallas.PAD, mode="edge")))


def _xla(img, border=19):
    return np.asarray(jorb.pack_comb(jorb.nms3x3(jorb.fast_score(jnp.asarray(img))), border))


def test_ring_matches_reference():
    assert tuple(map(tuple, jorb._FAST_RING)) == fast_nms.FAST_RING == fast_pallas.FAST_RING


@pytest.mark.parametrize("hw", LEVELS + [(37, 41)])
def test_plain_version_matches_pallas_and_xla(hw):
    h, w = hw
    img = _levels(h, w, seed=h)
    ours = n(fast_nms.fast_nms_comb(torch.from_numpy(img), 19))
    for c in range(img.shape[0]):
        xla = _xla(img[c])
        np.testing.assert_array_equal(ours[c], xla)
        if h * w <= 333 * 444 or c == 0:
            np.testing.assert_array_equal(_pallas(img[c]), xla)


def test_cpu_wrapper_takes_plain_version_and_validates():
    x = torch.zeros(40, 40)
    np.testing.assert_array_equal(n(fast_nms.fast_nms_comb(x)), n(fast_nms.fast_nms_comb_reference(x)))
    with pytest.raises(TypeError):
        fast_nms.fast_nms_comb(torch.zeros(40, 40, dtype=torch.float64))
    with pytest.raises(ValueError):
        fast_nms.fast_nms_comb(torch.zeros(2, 2, 40, 40))


@pytest.mark.parametrize("border", [19, 3, 0])
def test_cuda_source_host_emulation(tmp_path, border):
    """csrc/fast_nms.cu's kernel body compiled for the host (one thread per
    block) against the plain version, including odd level sizes and
    borders where the edge semantics matter."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no host C++ compiler to build the kernel body")
    exe = tmp_path / "fast_nms_emu"
    subprocess.run([gxx, "-O2", "-std=c++17", "-I", os.path.join(REPO, "eao_slam_torch", "csrc"),
                    "-o", str(exe), os.path.join(REPO, "tests", "fast_nms_host_emulation.cpp")],
                   check=True, capture_output=True, timeout=120)
    for h, w in [LEVELS[0], LEVELS[2], LEVELS[6], LEVELS[7], (20, 20)]:
        img = _levels(h, w, seed=w)
        out = subprocess.run([str(exe), "2", str(h), str(w), str(border)], input=img.tobytes(),
                             capture_output=True, check=True, timeout=120).stdout
        got = np.frombuffer(out, np.int32).reshape(img.shape)
        np.testing.assert_array_equal(got, n(fast_nms.fast_nms_comb_reference(torch.from_numpy(img), border)))


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the kernel has no interpret mode)")
    before = fast_nms.launches
    for h, w in LEVELS:
        x = torch.from_numpy(_levels(h, w, seed=h)).cuda().repeat(16, 1, 1)
        got = fast_nms.fast_nms_comb(x, 19)
        torch.cuda.synchronize()
        assert torch.equal(got, fast_nms.fast_nms_comb_reference(x, 19))
    assert fast_nms.launches == before + len(LEVELS)
