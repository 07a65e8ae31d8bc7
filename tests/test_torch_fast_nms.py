"""FAST-9/16 + 3x3 NMS + packing: the Pallas kernel (interpret mode), the
reference's XLA formulation, the port's plain PyTorch version and the
port's CUDA kernel all compute the same int32 map, bit for bit; so do the
kernel's tile-max entry and the padded maximum the reference takes of that
map.

Trouble spot named here: edge semantics. The Pallas kernel runs its NMS on
an extended domain of the edge-padded image, the XLA path pads the score
with -inf; they differ only within 4 px of the edge, which border=19
masks. The port's kernel and plain version use -inf outside the image and
agree with each other for any border, and with both reference forms at
border=19, on every full-width level size (odd ones included)."""

import os
import shutil
import subprocess
from functools import lru_cache, partial

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


@pytest.fixture(scope="module")
def emulator(tmp_path_factory):
    """csrc/fast_nms.cu's kernel body compiled for the host (the intrinsics
    get host forms with the same two-lane 16-bit semantics)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no host C++ compiler to build the kernel body")
    exe = str(tmp_path_factory.mktemp("emu") / "fast_nms_emu")
    subprocess.run([gxx, "-O2", "-std=c++17", "-I", os.path.join(REPO, "eao_slam_torch", "csrc"),
                    "-o", exe, os.path.join(REPO, "tests", "fast_nms_host_emulation.cpp")],
                   check=True, capture_output=True, timeout=300)
    return exe


def _emulate(exe, imgs, border, tile_max):
    """Run the host build on a list of [C, h, w] levels in one table walk."""
    C = imgs[0].shape[0]
    args = [exe, str(int(tile_max)), str(border), str(C), str(len(imgs))]
    for im in imgs:
        args += [str(im.shape[1]), str(im.shape[2])]
    out = subprocess.run(args, input=b"".join(im.tobytes() for im in imgs),
                         capture_output=True, check=True, timeout=300).stdout
    flat = np.frombuffer(out, np.int32)
    res, at = [], 0
    for im in imgs:
        shape = (C, -(-im.shape[1] // 16), -(-im.shape[2] // 16)) if tile_max else im.shape
        res.append(flat[at:at + int(np.prod(shape))].reshape(shape))
        at += int(np.prod(shape))
    assert at == flat.size
    return res


def _image(kind, h, w, seed):
    if kind == "random":          # frame 1 is quantised: plateaus, the >= tie rule
        return _levels(h, w, seed)
    if kind == "constant":        # every score is 0
        return np.stack([np.full((h, w), 77, np.float32), np.zeros((h, w), np.float32)])
    # flat ground with a few bright and dark squares: most scores are 0
    rng = np.random.default_rng(seed)
    img = np.full((2, h, w), 128, np.float32)
    for c in range(2):
        for _ in range(12):
            y, x = rng.integers(0, h - 4), rng.integers(0, w - 4)
            img[c, y:y + rng.integers(1, 9), x:x + rng.integers(1, 9)] = rng.integers(0, 256)
    return img


EMU_SIZES = [LEVELS[0], LEVELS[2], LEVELS[6], LEVELS[7], (20, 20)]


@lru_cache(maxsize=None)
def _case(kind, hw, border):
    """(image, plain full map, plain tile maximum) of one case, made once."""
    img = _image(kind, *hw, seed=hw[1])
    comb = fast_nms.fast_nms_comb_reference(torch.from_numpy(img), border)
    return img, n(comb), n(fast_nms.tile_max(comb, 16))


@pytest.mark.parametrize("border", [19, 3, 0])
def test_cuda_source_host_emulation(emulator, border):
    """The full-map entry of the host build against the plain version,
    including odd level sizes and borders where the edge semantics matter."""
    for hw in EMU_SIZES:
        img, want, _ = _case("random", hw, border)
        got, = _emulate(emulator, [img], border, tile_max=False)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("border", [19, 3])
@pytest.mark.parametrize("kind", ["random", "constant", "squares"])
@pytest.mark.parametrize("hw", EMU_SIZES)
@pytest.mark.parametrize("tile_max", [False, True], ids=["comb", "tile_max"])
def test_host_emulation_both_entries(emulator, tile_max, hw, kind, border):
    """Both entries, bit for bit, on random, plateau, constant and mostly
    flat images."""
    img, comb, tmax = _case(kind, hw, border)
    got, = _emulate(emulator, [img], border, tile_max)
    np.testing.assert_array_equal(got, tmax if tile_max else comb)


@pytest.mark.parametrize("hw", LEVELS + [(37, 41)])
@pytest.mark.parametrize("tile_max", [False, True], ids=["comb", "tile_max"])
def test_host_emulation_single_frame(emulator, tile_max, hw):
    """One frame, as a bootstrap frame gives it (a grid one frame deep), at
    every full-width level size and a small odd one."""
    img, comb, tmax = _case("random", hw, 19)
    got, = _emulate(emulator, [img[:1]], 19, tile_max)
    np.testing.assert_array_equal(got, (tmax if tile_max else comb)[:1])


@pytest.mark.parametrize("border", [19, 3, 0])
@pytest.mark.parametrize("tile_max", [False, True], ids=["comb", "tile_max"])
def test_host_emulation_multi_level_table(emulator, tile_max, border):
    """One walk over the table of levels (largest first, odd sizes among
    them) gives each level what a walk of its own gives."""
    cases = [_case("random" if i % 2 == 0 else "squares", hw, border)
             for i, hw in enumerate([LEVELS[2], LEVELS[5], LEVELS[6], LEVELS[7], (20, 20)])]
    together = _emulate(emulator, [c[0] for c in cases], border, tile_max)
    for (_, comb, tmax), got in zip(cases, together):
        np.testing.assert_array_equal(got, tmax if tile_max else comb)


@pytest.mark.parametrize("cell", [16, 8, 5])
@pytest.mark.parametrize("hw", [(161, 214), (134, 179), (20, 20)])
def test_tile_max_reference_is_the_padded_amax_of_the_reference(hw, cell):
    """fast_nms_tile_max on the CPU (any cell) equals the zero-padded
    reshape-and-max inside eao_slam_tpu.ops.orb.select_from_comb."""
    h, w = hw
    img = _levels(h, w, seed=h + cell)
    got = n(fast_nms.fast_nms_tile_max(torch.from_numpy(img), 19, cell))
    for c in range(img.shape[0]):
        comb = _xla(img[c])
        ph, pw = (-h) % cell, (-w) % cell
        sp = np.pad(comb, ((0, ph), (0, pw)))
        want = sp.reshape((h + ph) // cell, cell, (w + pw) // cell, cell).max((1, 3))
        np.testing.assert_array_equal(got[c], want)


def test_wrappers_take_tuples_and_validate():
    imgs = tuple(torch.from_numpy(_levels(h, w, seed=h)) for h, w in [(60, 70), (37, 41)])
    for fn, ref in ((fast_nms.fast_nms_comb, fast_nms.fast_nms_comb_reference),
                    (fast_nms.fast_nms_tile_max, fast_nms.fast_nms_tile_max_reference)):
        outs = fn(imgs, 3)
        assert isinstance(outs, tuple) and len(outs) == 2
        for x, o in zip(imgs, outs):
            np.testing.assert_array_equal(n(o), n(ref(x, 3)))
            np.testing.assert_array_equal(n(fn(x, 3)), n(o))
        assert fn(imgs[0][0], 3).shape == fn(imgs[0], 3).shape[1:]
        with pytest.raises(TypeError):
            fn(imgs[0].double())
        with pytest.raises(ValueError):
            fn(torch.zeros(2, 2, 40, 40))
        with pytest.raises(ValueError):
            fn(())
        with pytest.raises(ValueError):
            fn((imgs[0], imgs[1][:1]))
    with pytest.raises(ValueError):
        fast_nms.fast_nms_tile_max(imgs[0], 3, cell=0)
    before = dict(fast_nms.launches)
    fast_nms.fast_nms_tile_max(imgs, 3)
    assert fast_nms.launches == before          # the plain version counts no launch


def _cuda_levels(frames=32):
    """Levels of a chunk (32 frames) or of a bootstrap frame (1)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the kernel has no interpret mode)")
    return tuple(torch.from_numpy(_levels(h, w, seed=h)).cuda().repeat(16, 1, 1)[:frames].contiguous()
                 for h, w in LEVELS)


@pytest.mark.cuda
@pytest.mark.parametrize("frames", [32, 1])
def test_cuda_kernel_matches_plain_version(frames):
    xs = _cuda_levels(frames)
    before = fast_nms.launches["fast_nms_comb"]
    got = fast_nms.fast_nms_comb(xs, 19)
    torch.cuda.synchronize()
    for x, g in zip(xs, got):
        assert torch.equal(g, fast_nms.fast_nms_comb_reference(x, 19))
        assert torch.equal(fast_nms.fast_nms_comb(x, 19), g)
    assert fast_nms.launches["fast_nms_comb"] == before + 1 + len(LEVELS)


@pytest.mark.cuda
@pytest.mark.parametrize("frames", [32, 1])
def test_cuda_tile_max_matches_plain_version(frames):
    xs = _cuda_levels(frames)
    before = fast_nms.launches["fast_nms_tile_max"]
    got = fast_nms.fast_nms_tile_max(xs, 19)
    torch.cuda.synchronize()
    for x, g in zip(xs, got):
        assert torch.equal(g, fast_nms.fast_nms_tile_max_reference(x, 19, 16))
    assert fast_nms.launches["fast_nms_tile_max"] == before + 1
    with pytest.raises(ValueError):
        fast_nms.fast_nms_tile_max(xs, 19, cell=8)
