"""The port's line detector (``eao_slam_torch/ops/lines.py``) and Sobel
gradients against the reference package's, on the same numpy images: the
reference's drawn-segment and flat images (tests/test_lines_yaw.py) and one
rendered 640x480 frame of the bench arc.

The detector is held in stages, so that float noise in the bins does not
hide a real fault:
(a) the per-pixel bins: the edge masks agree but for pixels whose magnitude
    lies within float32 rounding of the tile threshold, the theta and rho
    bins agree on at least 99.99 % of the edge pixels, and every
    disagreement lies within 1e-4 rad (theta) or 1e-4 px (rho) of a bin
    edge (torch's and XLA's atan2 and cos differ in the last bits);
(b) fed the reference's own bins, the accumulator and the peaks are equal
    and the segments equal the reference's output (validity exact,
    endpoints 1e-3 px);
(c) end to end, the valid sets match and matched endpoints agree within
    1 px.
The reference's internals come from a replica of its code
(``eao_slam_tpu/ops/lines.py:57-137``) under ``jax.jit``; the replica's
output is checked against the reference function itself.

Sobel gradients agree to 1e-4; ``merge_collinear``'s mask is exact.
"""

from functools import lru_cache

import numpy as np
import pytest
import torch

from eao_slam_torch.ops import lines as TL
from eao_slam_torch.ops.image import sobel_gradients
from torch_parity import n, rendered_arc, t

MAX_LINES = 128


def drawn_image():
    """tests/test_lines_yaw.py's drawn segments on uniform noise."""
    from test_lines_yaw import draw_line

    img = np.random.default_rng(12345).uniform(95, 105, (480, 640)).astype(np.float32)
    for s in ((100.0, 100.0, 400.0, 120.0), (150.0, 300.0, 170.0, 450.0),
              (350.0, 200.0, 500.0, 380.0)):
        draw_line(img, *s)
    return img


def bench_frame():
    return rendered_arc()[2][0].astype(np.float32)


IMAGES = {"drawn": drawn_image, "flat": lambda: np.full((240, 320), 100.0, np.float32),
          "bench": bench_frame}


@lru_cache(maxsize=None)
def reference_stages(name: str, max_lines: int = MAX_LINES):
    """The reference detector's intermediates on one image, by a replica of
    its code under jit, as a dict of numpy arrays [T, ...] (bins, edge
    mask, theta, rho, magnitude and threshold, accumulator, peaks); its own
    output; and the tiles across."""
    import jax
    import jax.numpy as jnp

    from eao_slam_tpu.ops.image import sobel_gradients as jsobel
    from eao_slam_tpu.ops.lines import N_THETA, RHO_BIN, detect_segments

    img = IMAGES[name]()
    H, W = img.shape
    TH, TW = 120, 160
    nty, ntx = -(-H // TH), -(-W // TW)
    T = nty * ntx
    K = max(2, max_lines // T + 2)

    @jax.jit
    def stages(img):
        gx, gy, mag = jsobel(img)

        def tile(a):
            return a.reshape(nty, TH, ntx, TW).transpose(0, 2, 1, 3).reshape(T, TH, TW)

        gx_t, gy_t, mag_t = tile(gx), tile(gy), tile(mag)
        thr = jnp.maximum(40.0, 1.5 * jnp.mean(mag_t, axis=(1, 2)))[:, None, None]
        strong = mag_t > thr
        tile_diag = float(np.hypot(TH, TW))
        n_rho = int(2 * tile_diag / RHO_BIN) + 2
        ys = jnp.broadcast_to(jnp.arange(TH, dtype=jnp.float32)[:, None], (TH, TW))
        xs = jnp.broadcast_to(jnp.arange(TW, dtype=jnp.float32)[None, :], (TH, TW))
        theta = jnp.mod(jnp.arctan2(gy_t, gx_t), jnp.pi)
        t_bin = jnp.clip((theta / jnp.pi * N_THETA).astype(jnp.int32), 0, N_THETA - 1)
        t_centers = (jnp.arange(N_THETA) + 0.5) * (jnp.pi / N_THETA)
        rho = xs[None] * jnp.cos(t_centers)[t_bin] + ys[None] * jnp.sin(t_centers)[t_bin]
        r_bin = jnp.clip(((rho + tile_diag) / RHO_BIN).astype(jnp.int32), 0, n_rho - 1)

        def tile_acc(tb, rb, st):
            oh_t = ((tb.reshape(-1)[None, :] == jnp.arange(N_THETA)[:, None])
                    & st.reshape(-1)[None, :]).astype(jnp.float32)
            oh_r = (rb.reshape(-1)[:, None] == jnp.arange(n_rho)[None, :]).astype(jnp.float32)
            return oh_t @ oh_r

        acc = jax.vmap(tile_acc)(t_bin, r_bin, strong)
        pad = jnp.pad(acc, ((0, 0), (1, 1), (1, 1)))
        mx, acc3 = acc, acc
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy or dx:
                    sl = jax.lax.slice(pad, (0, 1 + dy, 1 + dx),
                                       (T, 1 + dy + N_THETA, 1 + dx + n_rho))
                    mx = jnp.maximum(mx, sl)
                    acc3 = acc3 + sl
        votes, flat = jax.lax.top_k(jnp.where(acc >= mx, acc3, 0.0).reshape(T, -1), K)
        return dict(t_bin=t_bin, r_bin=r_bin, strong=strong, theta=theta, rho=rho, mag=mag_t,
                    thr=thr, acc=acc, votes=votes, pk_t=flat // n_rho, pk_r=flat % n_rho)

    out = {k: np.asarray(v) for k, v in stages(jnp.asarray(img)).items()}
    segs, valid = detect_segments(jnp.asarray(img), max_lines=max_lines)
    return out, (np.asarray(segs), np.asarray(valid)), ntx


@pytest.mark.parametrize("name", ["drawn", "bench"])
def test_sobel_gradients(name):
    from eao_slam_tpu.ops.image import sobel_gradients as jsobel

    img = IMAGES[name]()
    for got, want in zip(sobel_gradients(t(img)), jsobel(img)):
        np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-4)
    batch = np.stack([img, img[::-1].copy()])
    for got, want in zip(sobel_gradients(t(batch)), jsobel(batch[1])):
        np.testing.assert_allclose(n(got[1]), np.asarray(want), atol=1e-4)


def _near_edge(value, step, tol=1e-4):
    """Whether value lies within tol of a multiple of step."""
    r = np.mod(value, step)
    return np.minimum(r, step - r) <= tol


@pytest.mark.parametrize("name", ["drawn", "bench"])
def test_stage_a_bins(name):
    ref, _, _ = reference_stages(name)
    bins = TL.hough_bins(t(IMAGES[name]())[None])
    st = n(bins.strong[0])
    differ = st != ref["strong"]
    mag = ref["mag"][differ]
    assert (np.abs(mag - np.broadcast_to(ref["thr"], ref["mag"].shape)[differ])
            <= 1e-5 * np.abs(mag)).all()
    both = st & ref["strong"]
    assert both.sum() > 1000
    t_diff = (n(bins.t_bin[0]) != ref["t_bin"]) & both
    r_diff = (n(bins.r_bin[0]) != ref["r_bin"]) & both & ~t_diff
    assert (t_diff | r_diff).sum() <= 1e-4 * both.sum(), ((t_diff | r_diff).sum(), both.sum())
    assert _near_edge(ref["theta"][t_diff], np.pi / 90).all()
    assert _near_edge(ref["rho"][r_diff] + 200.0, 3.0).all()


@pytest.mark.parametrize("name", ["drawn", "flat", "bench"])
def test_stage_b_from_the_reference_bins(name):
    ref, (segs, valid), ntx = reference_stages(name)
    bins = TL.HoughBins(*(t(ref[k])[None] for k in ("t_bin", "r_bin", "strong", "theta")), ntx)
    acc = TL.vote_accumulator(bins)
    np.testing.assert_array_equal(n(acc[0]), ref["acc"])
    v, pt, pr = TL.accumulator_peaks(acc, ref["votes"].shape[-1])
    for got, k in ((v, "votes"), (pt, "pk_t"), (pr, "pk_r")):
        np.testing.assert_array_equal(n(got[0]), ref[k], err_msg=k)
    s, ok = TL.peak_segments(bins, v, pt, pr, MAX_LINES)
    np.testing.assert_array_equal(n(ok[0]), valid)
    np.testing.assert_allclose(n(s[0])[valid], segs[valid], atol=1e-3)
    if name == "flat":
        assert not valid.any()
    else:
        assert valid.sum() >= 3


def _match(segs_a, segs_b, tol=1.0):
    """Segments of a with a segment of b within tol px at both endpoints
    (either direction)."""
    d = np.abs(segs_a[:, None, :] - segs_b[None, :, :]).max(-1)
    flip = np.abs(segs_a[:, None, :] - segs_b[None, :, [2, 3, 0, 1]]).max(-1)
    return (np.minimum(d, flip) <= tol).any(1)


@pytest.mark.parametrize("name", ["drawn", "flat", "bench"])
def test_stage_c_end_to_end(name):
    _, (segs, valid), _ = reference_stages(name)
    s, ok = TL.detect_segments(t(IMAGES[name]()), max_lines=MAX_LINES)
    s, ok = n(s), n(ok)
    np.testing.assert_array_equal(ok, valid)
    assert _match(s[ok], segs[valid]).all()


def test_batched_frames_equal_single_frames():
    """A batch in one call, across passes of the endpoint search, equals
    each frame alone."""
    three = [drawn_image(), bench_frame(), bench_frame()[:, ::-1].copy()]
    imgs = np.stack((three * (TL.FRAMES_PER_PASS // 3 + 1))[:TL.FRAMES_PER_PASS + 1])
    s, ok = TL.detect_segments(t(imgs), max_lines=MAX_LINES)
    for k in (0, 1, 2, TL.FRAMES_PER_PASS):
        s1, ok1 = TL.detect_segments(t(imgs[k]), max_lines=MAX_LINES)
        np.testing.assert_array_equal(n(ok[k]), n(ok1))
        np.testing.assert_array_equal(n(s[k]), n(s1))


def test_merge_collinear():
    from eao_slam_tpu.ops.lines import merge_collinear as jmerge

    segs = np.array([[100.0, 100.0, 200.0, 100.0], [210.0, 100.5, 320.0, 101.0],
                     [100.0, 300.0, 200.0, 300.0]], np.float32)
    _, keep = TL.merge_collinear(t(segs), torch.ones(3, dtype=torch.bool))
    np.testing.assert_array_equal(n(keep), [False, True, True])
    _, (bench_segs, bench_valid), _ = reference_stages("bench")
    rng = np.random.default_rng(3)
    for segs, valid in ((segs, np.ones(3, bool)), (bench_segs, bench_valid),
                        (bench_segs, bench_valid & (rng.random(MAX_LINES) < 0.7))):
        _, keep = TL.merge_collinear(t(segs), t(valid))
        np.testing.assert_array_equal(n(keep), np.asarray(jmerge(segs, valid)[1]))


def test_line_mode_front_end():
    """With line-alignment yaw on, a bootstrap frame (frame_from_image) and
    a chunk's batch (extract_batch, with boxes) carry each image's
    segments; without it, neither carries lines."""
    from eao_slam_torch.config import CapacityConfig, DemoFlag, tum3_config
    from eao_slam_torch.runtime.frame import empty_boxes, frame_from_image
    from eao_slam_torch.runtime.scan_tracker import extract_batch

    imgs = rendered_arc()[2][:2]
    cap = CapacityConfig(max_features=256, max_boxes=8)
    for flag in (DemoFlag.LINE_IFOREST, DemoFlag.EAO):
        cfg = tum3_config(flag).replace(capacity=cap)
        fr = frame_from_image(cfg, imgs[0], "cpu")
        boxes = tuple(torch.as_tensor(np.stack([x, x])) for x in empty_boxes(cfg))
        batch = extract_batch(cfg, torch.as_tensor(imgs), [0.0, 0.1], boxes=boxes)
        if flag == DemoFlag.EAO:
            assert fr.lines is None and batch.lines is None
            continue
        want = TL.detect_segments(t(imgs.astype(np.float32)), max_lines=cap.max_lines)
        np.testing.assert_array_equal(n(batch.lines), n(want[0]))
        np.testing.assert_array_equal(n(batch.line_valid), n(want[1]))
        np.testing.assert_array_equal(n(fr.lines), n(want[0][0]))
        assert n(fr.line_valid).sum() >= 10
