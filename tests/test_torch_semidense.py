"""Parity of the port's semi-dense pass (eao_slam_torch/dense/semidense.py)
with the reference's, on the CPU: the same numpy inputs through both.

Tolerances: ``bilinear`` 1e-6; the edge selection exact (the packed
``score << 20 | index`` values are unique; a Sobel magnitude that crosses
an integer under the int32 cast would move a slot, at most 0.1 % allowed);
``depth_sweep``: ``ok`` on >= 99 % of pixels and, where both packages pick
the same inverse-depth sample, rho and sigma to 1e-5 relative (the
linspace of the samples and the relative pose differ in the last bit, and
the parabolic refinement divides by a difference of scores); the fusion,
the inter-keyframe check and the rasterization on identical inputs to
1e-6 with the masks exact; end to end on the reference's 4-view fixture
the pixels exact, ``valid`` on >= 99 % and the inverse depth to 1e-4
relative where both are valid; ``save_obj`` byte-equal.
"""

from functools import lru_cache

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import n, t  # one torch thread per test worker

from eao_slam_tpu.dense import semidense as J
from eao_slam_torch.config import SemiDenseConfig
from eao_slam_torch.convert import semidense_result_from_numpy, semidense_result_to_numpy
from eao_slam_torch.dense import semidense as P
from eao_slam_torch.geometry.camera import TUM3


@lru_cache(maxsize=None)
def views():
    """tests/test_semidense.py's fixture: 4 rendered views of a room, 8 cm
    apart, looking at a point 4.5 m ahead; with ray-cast depth."""
    from eao_slam_torch.io.synthetic import look_at, make_room_scene, render_image

    scene = make_room_scene(seed=9, n_landmarks=50, n_objects=2)
    poses, imgs, depths = [], [], []
    for i in range(4):
        eye = np.array([-0.12 + 0.08 * i, 0.0, 0.0])
        T = look_at(eye, np.array([0.0, 0.0, 4.5])).astype(np.float32)
        img, z = render_image(scene, TUM3, T, return_depth=True)
        poses.append(T)
        imgs.append(img.astype(np.float32))
        depths.append(z)
    return np.stack(imgs), np.stack(poses), np.stack(depths)


def neighbors_of(K: int):
    return [[j for j in range(K) if j != k][:3] for k in range(K)]


@lru_cache(maxsize=None)
def reconstructions(n_pix: int = 2048, n_depth: int = 32):
    imgs, poses, _ = views()
    ranges = np.asarray([[2.0, 8.0]] * len(imgs), np.float32)
    ref = J.semidense_reconstruct(TUM3, imgs, poses, ranges, neighbors_of(len(imgs)),
                                  n_pix=n_pix, n_depth=n_depth)
    port = P.semidense_reconstruct(TUM3, imgs, poses, ranges, neighbors_of(len(imgs)),
                                   n_pix=n_pix, n_depth=n_depth, device="cpu")
    return ref, port


def test_bilinear_matches_reference():
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (37, 53)).astype(np.float32)
    uv = rng.uniform([-3, -3], [56, 40], (500, 2)).astype(np.float32)
    uv[:4] = [[0, 0], [52, 36], [51.9995, 35.9995], [-1, 40]]
    want = np.asarray(J.bilinear(jnp.asarray(img), jnp.asarray(uv)))
    np.testing.assert_allclose(n(P.bilinear(t(img), t(uv))), want, rtol=0, atol=1e-6 * 255)
    batch = np.stack([img, img[::-1].copy()])
    got = n(P.bilinear(t(batch), t(np.stack([uv, uv])), torch.arange(2)[:, None]))
    np.testing.assert_allclose(got[0], want, rtol=0, atol=1e-6 * 255)
    np.testing.assert_allclose(
        got[1], np.asarray(J.bilinear(jnp.asarray(batch[1]), jnp.asarray(uv))), rtol=0,
        atol=1e-6 * 255)


@pytest.mark.parametrize("k, n_pix", [(0, 512), (0, 2048), (3, 2048)])
def test_select_edge_pixels_is_the_references_selection(k, n_pix):
    img = views()[0][k]
    uv_j, v_j = (np.asarray(a) for a in J.select_edge_pixels(jnp.asarray(img), n_pix))
    uv_p, v_p = (n(a) for a in P.select_edge_pixels(t(img), n_pix))
    differ = (np.abs(uv_j - uv_p).max(1) > 0) | (v_j != v_p)
    assert differ.sum() <= 0.001 * n_pix, np.flatnonzero(differ)
    assert v_p.sum() > 0.5 * n_pix


def reference_sweep_with_samples(monkeypatch, *args):
    """The reference's depth_sweep, run op by op, and the inverse-depth
    sample it picked per pixel (its argmin, caught on the way)."""
    import jax.numpy as jnp_mod

    caught = {}
    argmin = jnp_mod.argmin

    def spy(a, axis=None, **kw):
        caught["best"] = argmin(a, axis=axis, **kw)
        return caught["best"]

    monkeypatch.setattr(jnp_mod, "argmin", spy)
    rho, sigma, ok = J.depth_sweep.__wrapped__(*args)
    monkeypatch.setattr(jnp_mod, "argmin", argmin)
    return np.asarray(rho), np.asarray(sigma), np.asarray(ok), np.asarray(caught["best"])


@pytest.mark.parametrize("nb", [1, 3])
def test_depth_sweep_matches_reference(monkeypatch, nb):
    imgs, poses, _ = views()
    uv, pxv = J.select_edge_pixels(jnp.asarray(imgs[0]), 2048)
    rmin, rmax = np.float32(1 / 8.0), np.float32(1 / 2.0)
    rho_j, sig_j, ok_j, best_j = reference_sweep_with_samples(
        monkeypatch, TUM3, jnp.asarray(imgs[0]), jnp.asarray(imgs[nb]), jnp.asarray(poses[0]),
        jnp.asarray(poses[nb]), uv, pxv, jnp.float32(rmin), jnp.float32(rmax),
        J.SemiDenseConfig(), 32)
    sd = SemiDenseConfig()
    rho_p, sig_p, ok_p, best_p = (n(a)[0] for a in P._sweep(
        TUM3, P._gradients(t(imgs[0])), P._gradients(t(imgs[nb:nb + 1])), t(poses[0]),
        t(poses[nb:nb + 1]), t(uv), t(pxv), torch.tensor(rmin), torch.tensor(rmax), sd, 32))
    assert (ok_j == ok_p).mean() >= 0.99
    same = ok_j & ok_p & (best_j == best_p)
    assert same.sum() >= 0.99 * (ok_j & ok_p).sum() and same.sum() > 500
    np.testing.assert_allclose(rho_p[same], rho_j[same], rtol=1e-5)
    np.testing.assert_allclose(sig_p[same], sig_j[same], rtol=1e-5)
    # the public entry is the same sweep, and so is the batch of all the
    # neighbours pass 1 runs
    r1, s1, o1 = (n(a) for a in P.depth_sweep(TUM3, t(imgs[0]), t(imgs[nb]), t(poses[0]),
                                              t(poses[nb]), t(uv), t(pxv), rmin, rmax, sd, 32))
    rb, _, ob, _ = (n(a) for a in P._sweep(
        TUM3, P._gradients(t(imgs[0])), P._gradients(t(imgs[1:])), t(poses[0]), t(poses[1:]),
        t(uv), t(pxv), torch.tensor(rmin), torch.tensor(rmax), sd, 32))
    for a, b in ((r1, rho_p), (s1, sig_p), (o1, ok_p), (rb[nb - 1], rho_p), (ob[nb - 1], ok_p)):
        np.testing.assert_array_equal(a, b)


def test_fuse_hypotheses_matches_reference():
    rng = np.random.default_rng(3)
    N, Hn = 400, 7
    base = rng.uniform(0.1, 0.5, (N, 1))
    rho = (base + rng.normal(0, 0.004, (N, Hn)) * (rng.random((N, Hn)) < 0.7)
           + rng.uniform(-0.2, 0.2, (N, Hn)) * (rng.random((N, Hn)) < 0.3)).astype(np.float32)
    sigma = rng.uniform(0.001, 0.01, (N, Hn)).astype(np.float32)
    ok = rng.random((N, Hn)) < 0.8
    want = [np.asarray(a) for a in J.fuse_hypotheses(jnp.asarray(rho), jnp.asarray(sigma),
                                                      jnp.asarray(ok), 3)]
    got = [n(a) for a in P.fuse_hypotheses(t(rho), t(sigma), t(ok), 3)]
    np.testing.assert_array_equal(got[2], want[2])
    assert 0.2 < want[2].mean() < 0.95
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6)


def gt_depth_inputs(n_pix: int = 1024):
    """Each view's edge pixels at their ray-cast inverse depths (the
    reference's inter-keyframe test)."""
    imgs, poses, depths = views()
    H, W = imgs.shape[1:]
    out = []
    for k in range(len(imgs)):
        uv, pxv = (np.asarray(a) for a in J.select_edge_pixels(jnp.asarray(imgs[k]), n_pix))
        z = depths[k][np.clip(uv[:, 1].astype(int), 0, H - 1), np.clip(uv[:, 0].astype(int), 0,
                                                                       W - 1)]
        ok = pxv & np.isfinite(z) & (z > 0.1)
        rho = np.where(ok, 1.0 / np.maximum(np.where(np.isfinite(z), z, 1.0), 0.1),
                       0.0).astype(np.float32)
        out.append((uv, rho, ok))
    return out


def test_rasterize_depth_keeps_the_references_last_write():
    """Stamps of neighbouring pixels collide on most cells; the reference
    on the CPU keeps the last write in offset-then-pixel order."""
    rng = np.random.default_rng(4)
    H, W, N = 24, 32, 300
    uv = rng.integers([0, 0], [W, H], (N, 2)).astype(np.float32)
    uv[:40] = uv[40:80]                       # exact duplicates too
    uv[80:90] += 0.5                          # round half to even
    rho = rng.uniform(0.1, 1.0, N).astype(np.float32)
    sigma = rng.uniform(0.001, 0.02, N).astype(np.float32)
    valid = rng.random(N) < 0.85
    for dilate in (0, 1, 2):
        want = [np.asarray(a) for a in J.rasterize_depth(
            jnp.asarray(uv), jnp.asarray(rho), jnp.asarray(sigma), jnp.asarray(valid), H, W,
            dilate=dilate)]
        got = [n(a) for a in P.rasterize_depth(t(uv), t(rho), t(sigma), t(valid), H, W,
                                               dilate=dilate)]
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    assert (want[0] > 0).mean() > 0.5


def test_inter_kf_check_matches_reference():
    imgs, poses, _ = views()
    H, W = imgs.shape[1:]
    inputs = gt_depth_inputs()
    N = len(inputs[0][0])
    rng = np.random.default_rng(5)
    uv0, rho0, ok0 = inputs[0]
    corrupt = rng.random(N) < 0.3
    rho_bad = np.where(corrupt, rho0 * 1.8, rho0).astype(np.float32)
    maps_j = [J.rasterize_depth(jnp.asarray(u), jnp.asarray(r), jnp.full((N,), 0.01),
                                jnp.asarray(o), H, W) for u, r, o in inputs[1:]]
    rho_maps = np.stack([np.asarray(m[0]) for m in maps_j])
    sig_maps = np.stack([np.asarray(m[1]) for m in maps_j])
    want = [np.asarray(a) for a in J.inter_kf_check(
        TUM3, jnp.asarray(uv0), jnp.asarray(rho_bad), jnp.asarray(ok0), jnp.asarray(poses[0]),
        jnp.asarray(poses[1:]), jnp.asarray(rho_maps), jnp.asarray(sig_maps), min_support=1)]
    got = [n(a) for a in P.inter_kf_check(TUM3, t(uv0), t(rho_bad), t(ok0), t(poses[0]),
                                          t(poses[1:]), t(rho_maps), t(sig_maps), min_support=1)]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    assert want[1][~corrupt & ok0].mean() > 0.3 and want[1][corrupt & ok0].mean() < 0.1
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)


def test_semidense_reconstruct_matches_reference():
    ref, port = reconstructions()
    pix_j, pix_p = np.asarray(ref.pixels), n(port.pixels)
    np.testing.assert_array_equal(pix_p, pix_j)
    val_j, val_p = np.asarray(ref.valid), n(port.valid)
    assert (val_j == val_p).mean() >= 0.99, (val_j == val_p).mean()
    both = val_j & val_p
    assert both.sum() > 1000
    np.testing.assert_allclose(n(port.inv_depth)[both], np.asarray(ref.inv_depth)[both],
                               rtol=1e-4)
    np.testing.assert_allclose(n(port.points_w)[both], np.asarray(ref.points_w)[both],
                               rtol=1e-4, atol=1e-5)


def test_port_meets_the_references_depth_accuracy():
    """tests/test_semidense.py's accuracy gates on the port: keyframe 0's
    fused depths against ray-cast depth."""
    imgs, poses, depths = views()
    res = P.semidense_reconstruct(TUM3, imgs, poses, np.asarray([[2.0, 8.0]] * 4, np.float32),
                                  neighbors_of(4), n_pix=4096, n_depth=96, device="cpu")
    uv, val, rho = n(res.pixels[0]), n(res.valid[0]), n(res.inv_depth[0])
    gt_z = depths[0][uv[:, 1].astype(int), uv[:, 0].astype(int)]
    ok = val & np.isfinite(gt_z)
    assert ok.sum() > 300
    rel = np.abs(1.0 / np.maximum(rho[ok], 1e-6) - gt_z[ok]) / gt_z[ok]
    assert np.median(rel) < 0.05 and (rel < 0.1).mean() > 0.6


def test_save_obj_is_byte_equal(tmp_path):
    ref, _ = reconstructions()
    d = {k: np.asarray(v) for k, v in ref._asdict().items()}
    port = semidense_result_from_numpy(d, "cpu")
    for k, v in semidense_result_to_numpy(port).items():
        np.testing.assert_array_equal(v, d[k])
    for sigma_max in (0.05, 1e9):
        a, b = tmp_path / "ref.obj", tmp_path / "port.obj"
        assert J.save_obj(str(a), ref, sigma_max) == P.save_obj(str(b), port, sigma_max) > 0
        assert a.read_bytes() == b.read_bytes()
