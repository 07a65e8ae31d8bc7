"""The port's dataset decoder (``io/native_loader.SequenceLoader``) against
the reference's, on the same PNG files (tests/test_native_loader.py's
sequence): the native backend (the repository's loader, built by each
package into its own place) frame for frame byte-equal, with many threads
and a short ring in order, an unreadable file skipped; the cv2 backend
equal to cv2; ``backend`` says which decoder ran, and with neither the
loader raises."""

import os

import cv2
import numpy as np
import pytest

from eao_slam_torch.io import native_loader as tnl
from eao_slam_tpu.io import native_loader as jnl


@pytest.fixture(scope="module")
def png_sequence(tmp_path_factory):
    rng = np.random.default_rng(0)
    d = tmp_path_factory.mktemp("seq")
    files, stamps = [], []
    for i in range(6):
        img = rng.integers(0, 256, (120, 160), dtype=np.uint8)
        if i == 5:                          # an RGB file: the BT.601 grey path
            img = rng.integers(0, 256, (120, 160, 3), dtype=np.uint8)
        name = f"{i:04d}.png"
        cv2.imwrite(str(d / name), img)
        files.append(name)
        stamps.append(1000.0 + i / 30.0)
    return str(d), files, stamps


def _frames(module, d, files, stamps, w=160, h=120, **kw):
    with module.SequenceLoader(d, files, stamps, w, h, **kw) as ld:
        return [(i, t, img) for i, t, img in ld], getattr(ld, "backend", None)


def test_native_backend_is_built_in_the_ports_build_directory():
    assert tnl.native_available()
    assert os.path.dirname(tnl.LIBRARY).endswith(os.path.join("build", "eao_slam_torch"))
    assert os.path.exists(tnl.LIBRARY)


@pytest.mark.parametrize("threads,ring", [(2, 8), (3, 4), (4, 2)])
def test_native_frames_equal_the_reference(png_sequence, threads, ring):
    d, files, stamps = png_sequence
    got, backend = _frames(tnl, d, files, stamps, n_threads=threads, ring=ring)
    want, _ = _frames(jnl, d, files, stamps, n_threads=threads, ring=ring)
    assert backend == "native"
    assert [i for i, _, _ in got] == list(range(6))
    assert len(got) == len(want)
    for (i, t, img), (j, u, ref) in zip(got, want):
        assert i == j and t == u and img.dtype == np.float32
        assert img.tobytes() == ref.tobytes()


def test_native_frames_resized_like_the_reference(png_sequence):
    """A loader size other than the files': nearest-pixel drop, the same
    bytes in both packages."""
    d, files, stamps = png_sequence
    got, _ = _frames(tnl, d, files, stamps, w=97, h=61)
    want, _ = _frames(jnl, d, files, stamps, w=97, h=61)
    assert [img.tobytes() for _, _, img in got] == [img.tobytes() for _, _, img in want]


def test_cv2_backend_equals_cv2_and_the_reference(png_sequence):
    d, files, stamps = png_sequence
    got, backend = _frames(tnl, d, files, stamps, force_fallback=True)
    want, _ = _frames(jnl, d, files, stamps, force_fallback=True)
    assert backend == "cv2"
    assert [img.tobytes() for _, _, img in got] == [img.tobytes() for _, _, img in want]
    for (i, _, img), name in zip(got, files):
        ref = cv2.imread(os.path.join(d, name), cv2.IMREAD_GRAYSCALE)
        np.testing.assert_array_equal(img.astype(np.uint8), ref)


@pytest.mark.parametrize("fallback", [False, True])
def test_unreadable_file_skipped(png_sequence, fallback):
    d, files, stamps = png_sequence
    bad = files[:3] + ["missing.png"] + files[3:]
    bstamps = stamps[:3] + [2000.0] + stamps[3:]
    got, _ = _frames(tnl, d, bad, bstamps, force_fallback=fallback)
    want, _ = _frames(jnl, d, bad, bstamps, force_fallback=fallback)
    assert [i for i, _, _ in got] == [i for i, _, _ in want] == [0, 1, 2, 4, 5, 6]
    assert [t for _, t, _ in got] == [t for _, t, _ in want]


def test_no_decoder_raises(png_sequence, monkeypatch):
    d, files, stamps = png_sequence
    monkeypatch.setattr(tnl, "_cv2", lambda: None)
    with pytest.raises(RuntimeError, match="no image decoder"):
        tnl.SequenceLoader(d, files, stamps, 160, 120, force_fallback=True)
    monkeypatch.setattr(tnl, "_load", lambda: None)
    with pytest.raises(RuntimeError, match="no image decoder"):
        tnl.SequenceLoader(d, files, stamps, 160, 120)
