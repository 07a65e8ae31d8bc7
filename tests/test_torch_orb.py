"""Parity of the port's ORB front end with eao_slam_tpu.ops.orb.

Both packages get the JAX pyramid of the same rendered frame, so FAST maps
and keypoint selection compare bit for bit.

Trouble spots named here:
- top-k ties: tile scores are integers, so ties are common; the port ranks
  with a stable descending sort, which puts the lower tile first as
  jax.lax.top_k does. Keypoints, octaves, responses and validity: exact.
- BRIEF numerics: JAX multiplies integer patches by a bf16-rounded sampling
  table with f32 accumulation; the port rounds the same table to bf16 and
  multiplies in f32. Products are exact, only the summation order differs,
  so bits whose difference is near 0 may flip: at most 0.1% of valid
  descriptor bits may differ. Angles (the same polynomial atan2 on moments
  summed in another order): 1e-4 rad.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eao_slam_tpu.ops import image as jimage, orb as jorb
from eao_slam_torch.ops import orb as torb
from torch_parity import desc_bits_differ, n, rendered_arc, t


def test_brief_pattern_regenerated_equal():
    np.testing.assert_array_equal(torb.BRIEF_PATTERN, jorb.BRIEF_PATTERN)
    np.testing.assert_array_equal(torb._brief_table_np(), jorb._brief_onehot_blurfolded())
    np.testing.assert_array_equal(
        n(torb._brief_table(torch.device("cpu"))),
        np.asarray(jorb._BRIEF_OH_RAW.astype(jnp.float32)))


def test_small_helpers():
    assert torb.per_level_counts(1024, 8, 1.2) == jorb.per_level_counts(1024, 8, 1.2)
    assert torb.per_level_counts(256, 8, 1.2) == jorb.per_level_counts(256, 8, 1.2)
    np.testing.assert_array_equal(n(torb.scale_sigma2(8, 1.2)), np.asarray(jorb.scale_sigma2(8, 1.2)))
    rng = np.random.default_rng(0)
    y, x = rng.normal(0, 100, (2, 1000)).astype(np.float32)
    np.testing.assert_allclose(n(torb.fast_atan2(t(y), t(x))),
                               np.asarray(jorb.fast_atan2(jnp.asarray(y), jnp.asarray(x))), atol=1e-6)


def test_select_from_comb_ties():
    rng = np.random.default_rng(1)
    h, w = 161, 214
    score = rng.integers(0, 4, (h, w)).astype(np.int32) * 10   # many equal tile maxima
    idx = np.arange(h * w, dtype=np.int32).reshape(h, w)
    comb = (score << 20) | idx
    for n_out in (40, 200):
        yj, rj, vj = jorb.select_from_comb(jnp.asarray(comb), n_out, 20.0, 7.0, 16)
        yt, rt, vt = torb.select_from_comb(t(comb)[None], n_out, 20.0, 7.0, 16)
        np.testing.assert_array_equal(n(yt[0]), np.asarray(yj))
        np.testing.assert_array_equal(n(rt[0]), np.asarray(rj))
        np.testing.assert_array_equal(n(vt[0]), np.asarray(vj))


@pytest.mark.parametrize("hw", [(161, 214), (134, 179)])
@pytest.mark.parametrize("n_out", [40, 200])
def test_tile_max_then_select_equals_select_from_comb(hw, n_out):
    """The tile-max entry composed with select_from_tile_max picks exactly
    what the port's and the reference's select_from_comb pick from the full
    map, at odd level sizes (ragged last row and column of cells)."""
    from eao_slam_torch.ops import fast_nms

    h, w = hw
    rng = np.random.default_rng(h)
    img = rng.integers(0, 256, (2, h, w)).astype(np.float32)
    img[1] = np.round(img[1] / 64) * 64
    x = t(img)
    comb = fast_nms.fast_nms_comb_reference(x, 19)
    split = torb.select_from_tile_max(fast_nms.fast_nms_tile_max_reference(x, 19, 16),
                                      w, n_out, 20.0, 7.0)
    whole = torb.select_from_comb(comb, n_out, 20.0, 7.0, 16)
    for a, b in zip(split, whole):
        np.testing.assert_array_equal(n(a), n(b))
    for c in range(2):
        ref = jorb.select_from_comb(jnp.asarray(n(comb[c])), n_out, 20.0, 7.0, 16)
        for a, b in zip(split, ref):
            np.testing.assert_array_equal(n(a[c]), np.asarray(b))


def test_extract_orb_launch_shape_on_cpu():
    """extract_orb asks for all levels' tile maxima in one call and builds no
    full map: on the CPU that call goes to the plain version, level by level."""
    from eao_slam_torch.ops import fast_nms

    img = t(rendered_arc()[2][3].astype(np.float32))[None]
    levels = torb.image_ops.build_pyramid(img, 8, 1.2)
    maxima = fast_nms.fast_nms_tile_max(tuple(levels), 19, 16)
    assert [tuple(m.shape) for m in maxima] == [
        (1, -(-l.shape[-2] // 16), -(-l.shape[-1] // 16)) for l in levels]
    f = torb.extract_orb(img, n_features=256)
    counts = torb.per_level_counts(256, 8, 1.2)
    at = 0
    for l, m in enumerate(maxima):
        yx, resp, valid = torb.select_from_tile_max(m, levels[l].shape[-1], counts[l], 20.0, 7.0)
        np.testing.assert_array_equal(n(f.response[0, at:at + counts[l]]), n(resp[0]))
        np.testing.assert_array_equal(n(f.valid[0, at:at + counts[l]]), n(valid[0]))
        at += counts[l]


@pytest.mark.parametrize("frame", [3, 20])
def test_extract_orb_parity(frame):
    img = rendered_arc()[2][frame].astype(np.float32)
    jf = jorb.extract_orb(jnp.asarray(img), n_features=512)
    levels = tuple(torch.from_numpy(np.array(l))[None]
                   for l in jimage.build_pyramid(jnp.asarray(img), 8, 1.2))
    tf = torb.extract_orb(None, n_features=512, levels=levels)
    v = np.asarray(jf.valid)
    assert v.sum() > 400
    np.testing.assert_array_equal(n(tf.valid[0]), v)
    np.testing.assert_array_equal(n(tf.kp[0])[v], np.asarray(jf.kp)[v])
    np.testing.assert_array_equal(n(tf.octave[0]), np.asarray(jf.octave))
    np.testing.assert_array_equal(n(tf.response[0]), np.asarray(jf.response))
    np.testing.assert_allclose(n(tf.angle[0])[v], np.asarray(jf.angle)[v], atol=1e-4)
    flipped = desc_bits_differ(n(tf.desc[0])[v], np.asarray(jf.desc)[v])
    assert flipped <= 0.001 * v.sum() * 256, flipped
