"""Parity of the port's image pyramid with jax.image.resize (bilinear,
antialiased) + rounding.

Trouble spot named here: pyramid resampling. The port builds the same
per-axis triangle-filter weight matrices (checked against JAX's own
compute_weight_mat: equal but for a few entries one float32 ulp apart,
from the order of the column-sum) and applies them in float32 with TF32 off; sums
taken in another order can land an x.5 value on the other side of the
rounding. Allowed: at most 0.1% of a level's pixels off, by exactly 1 grey
level. Downstream tests feed the JAX pyramid to both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.image import scale as jscale

from eao_slam_tpu.ops import image as jimage
from eao_slam_torch.ops import image as timage
from torch_parity import n, rendered_arc


def test_level_sizes_and_gaussian():
    assert timage.level_sizes(480, 640, 8, 1.2) == jimage.level_sizes(480, 640, 8, 1.2)
    np.testing.assert_array_equal(timage.gaussian_kernel1d(2.0, 3), jimage.gaussian_kernel1d(2.0, 3))


@pytest.mark.parametrize("sizes", [(480, 400), (640, 533), (333, 278), (179, 149), (100, 100)])
def test_resize_weights_match(sizes):
    m, o = sizes
    want = np.asarray(jscale.compute_weight_mat(m, o, o / m, 0.0, jscale._fill_triangle_kernel, True))
    got = timage.resize_weights(m, o)
    assert (got != want).sum() <= 1e-4 * want.size
    np.testing.assert_allclose(got, want, rtol=0, atol=1.2e-7)  # one ulp below 1.0


@pytest.mark.parametrize("source", ["rendered", "noise"])
def test_pyramid_parity(source):
    if source == "rendered":
        img = rendered_arc()[2][5].astype(np.float32)
    else:
        img = np.random.default_rng(0).integers(0, 256, (480, 640)).astype(np.float32)
    jl = jimage.build_pyramid(jnp.asarray(img), 8, 1.2)
    tl = timage.build_pyramid(torch.from_numpy(img), 8, 1.2)
    for a, b in zip(jl, tl):
        a, b = np.asarray(a), n(b)
        assert a.shape == b.shape
        d = np.abs(a - b)
        assert d.max() <= 1.0
        assert (d > 0).sum() <= 0.001 * d.size, f"{(d > 0).sum()} pixels off at {a.shape}"
