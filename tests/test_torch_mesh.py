"""Parity of the port's surface stage (eao_slam_torch/dense/mesh.py) with
the reference's, on the CPU.

Tolerances: ``densify_depth`` exact (maxima only); ``tsdf_fuse`` to 1e-5
on >= 99.9 % of voxels and the weights exact on as many (the views are
summed in the reference's order; a voxel whose projection lands one ulp
across a pixel edge reads another depth); ``marching_tetrahedra`` from the
same field the same number of valid triangles, in the reference's order,
to 1e-5; ``extract_mesh`` on one semi-dense result the triangle count
within 0.5 % and vertices to 1e-4 m where the counts agree; the
reference's flat-wall test holds on the port; ``save_mesh_obj``
byte-equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from torch_parity import n, t  # one torch thread per test worker

from eao_slam_tpu.dense import mesh as J
from eao_slam_torch.dense import mesh as P
from eao_slam_torch.geometry.camera import TUM3


def small_cam():
    return TUM3._replace(width=160, height=120, fx=140.0, fy=140.0, cx=80.0, cy=60.0)


def test_case_table_is_the_references():
    np.testing.assert_array_equal(P._TETS, J._TETS)
    np.testing.assert_array_equal(P._CORNER_OFF, J._CORNER_OFF)


@pytest.mark.parametrize("dilate", [0, 1, 2])
def test_densify_depth_is_exact(dilate):
    rng = np.random.default_rng(dilate)
    H, W = 60, 80
    px = rng.uniform([-2, -2], [W + 2, H + 2], (500, 2)).astype(np.float32)
    px[:50] = px[50:100]                      # several samples per pixel
    rho = rng.uniform(0.0, 0.5, 500).astype(np.float32)
    valid = rng.random(500) < 0.8
    want = np.asarray(J.densify_depth(jnp.asarray(px), jnp.asarray(rho), jnp.asarray(valid),
                                      H, W, dilate=dilate))
    got = n(P.densify_depth(t(px), t(rho), t(valid), H, W, dilate=dilate))
    np.testing.assert_array_equal(got, want)


def views_of_a_box(K: int = 4):
    """K depth maps of a box room (a back wall and a box in front of it)
    seen from cameras around the origin, and their poses."""
    from eao_slam_torch.io.synthetic import look_at

    cam = small_cam()
    H, W = cam.height, cam.width
    v, u = np.mgrid[0:H, 0:W]
    rays = np.stack([(u - cam.cx) / cam.fx, (v - cam.cy) / cam.fy, np.ones((H, W))], -1)
    poses, depths = [], []
    for k in range(K):
        eye = np.array([-0.3 + 0.2 * k, 0.05 * k, 0.0])
        T = look_at(eye, np.array([0.0, 0.0, 4.0])).astype(np.float32)
        R = T[:3, :3].astype(np.float64)
        c = -R.T @ T[:3, 3].astype(np.float64)       # camera centre
        d = rays @ R                                   # world rays, unit camera z
        t_wall = (4.5 - c[2]) / d[..., 2]
        t_box = (3.5 - c[2]) / d[..., 2]               # the box's front face
        hit = c + t_box[..., None] * d
        on_box = (np.abs(hit[..., 0]) < 0.4) & (np.abs(hit[..., 1]) < 0.3)
        depth = np.where(on_box, t_box, t_wall).astype(np.float32)   # camera z = t
        depth[(u + v + k) % 11 == 0] = 0.0            # holes
        poses.append(T)
        depths.append(depth)
    return cam, np.stack(depths), np.stack(poses)


def fused(n_vox: int = 28):
    cam, depths, poses = views_of_a_box()
    origin = np.asarray([-1.0, -0.8, 3.0], np.float32)
    voxel = np.float32(2.0 / (n_vox - 1))
    want = [np.asarray(a) for a in J.tsdf_fuse(cam, jnp.asarray(depths), jnp.asarray(poses),
                                               jnp.asarray(origin), jnp.float32(voxel),
                                               nx=n_vox, ny=n_vox, nz=n_vox)]
    got = [n(a) for a in P.tsdf_fuse(cam, t(depths), t(poses), t(origin), voxel, nx=n_vox,
                                     ny=n_vox, nz=n_vox)]
    return want, got, origin, voxel


@pytest.mark.parametrize("n_vox", [24, 32])
def test_tsdf_fuse_matches_reference(n_vox):
    want, got, _, _ = fused(n_vox)
    close = np.abs(got[0] - want[0]) <= 1e-5
    assert close.mean() >= 0.999, close.mean()
    assert (got[1] == want[1]).mean() >= 0.999
    assert (want[1] >= 2).mean() > 0.05 and (want[0] < 0).any()


@pytest.mark.parametrize("n_slabs, max_tris", [(16, 200_000), (4, 3000), (3, 500)])
def test_marching_tetrahedra_matches_reference(n_slabs, max_tris):
    """Same field in (the reference's), same triangles out in the same
    order; the small budgets truncate per slab and overall."""
    want_f, _, origin, voxel = fused(28)
    tsdf, w = want_f
    a, av = (np.asarray(x) for x in J.marching_tetrahedra(
        jnp.asarray(tsdf), jnp.asarray(w), jnp.asarray(origin), jnp.float32(voxel),
        max_tris=max_tris, n_slabs=n_slabs))
    b, bv = (n(x) for x in P.marching_tetrahedra(t(tsdf), t(w), t(origin), voxel,
                                                 max_tris=max_tris, n_slabs=n_slabs))
    assert av.shape == bv.shape
    np.testing.assert_array_equal(bv, av)
    assert av.sum() > 100
    np.testing.assert_allclose(b[bv], a[av], rtol=0, atol=1e-5)


def box_result(stride: int = 2) -> dict:
    """A semi-dense result, as arrays, of the box room's views: every
    ``stride``-th pixel with depth, at its true inverse depth."""
    cam, depths, poses = views_of_a_box()
    v, u = np.mgrid[0:cam.height:stride, 0:cam.width:stride]
    px = np.stack([u.ravel(), v.ravel()], -1).astype(np.float32)
    z = depths[:, v.ravel(), u.ravel()]
    valid = z > 0
    rho = np.where(valid, 1.0 / np.where(valid, z, 1.0), 0.0).astype(np.float32)
    xn = np.stack([(px[:, 0] - cam.cx) / cam.fx, (px[:, 1] - cam.cy) / cam.fy,
                   np.ones(len(px))], -1)
    pts = []
    for k in range(len(poses)):
        Xc = xn * z[k][:, None]
        pts.append((Xc - poses[k][:3, 3]) @ poses[k][:3, :3])
    K = len(poses)
    return cam, poses, {"pixels": np.broadcast_to(px, (K,) + px.shape).copy(), "inv_depth": rho,
                        "sigma": np.full(rho.shape, 0.01, np.float32), "valid": valid,
                        "points_w": np.stack(pts).astype(np.float32)}


def test_extract_mesh_from_one_semidense_result():
    """One semi-dense result (the box room's views) through both
    extractors: the grid from its percentiles, densify, fuse, extract."""
    from eao_slam_tpu.dense.semidense import SemiDenseResult

    from eao_slam_torch.convert import semidense_result_from_numpy

    cam, poses, d = box_result()
    ref = SemiDenseResult(**{k: jnp.asarray(v) for k, v in d.items()})
    tj, nj = J.extract_mesh(cam, ref, poses, cam.height, cam.width, n_voxels=32)
    tp, np_ = P.extract_mesh(cam, semidense_result_from_numpy(d, "cpu"), poses, cam.height,
                             cam.width, n_voxels=32)
    assert nj > 100 and abs(np_ - nj) <= 0.005 * nj, (nj, np_)
    if np_ == nj:
        np.testing.assert_allclose(tp, tj, rtol=0, atol=1e-4)


def test_flat_wall_on_the_port():
    """tests/test_mesh.py::test_tsdf_of_flat_wall on the port: the zero
    crossing of a frontal wall at z = 4 lies on z = 4, and so do the
    triangles."""
    cam = small_cam()
    H, W = cam.height, cam.width
    depth = np.full((1, H, W), 4.0, np.float32)
    pose = np.concatenate([np.eye(3), np.zeros((3, 1))], 1)[None].astype(np.float32)
    nv = 48
    origin = np.asarray([-1.0, -1.0, 3.0], np.float32)
    voxel = np.float32(2.0 / (nv - 1))
    tsdf, w = P.tsdf_fuse(cam, t(depth), t(pose), t(origin), voxel, nx=nv, ny=nv, nz=nv)
    zs = origin[2] + voxel * np.arange(nv)
    mid = nv // 2
    col, wt = n(tsdf)[mid, mid, :], n(w)[mid, mid, :]
    seen = wt > 0
    assert (col[seen & (zs < 3.8)] > 0).all() and (col[seen & (zs > 4.2)] <= 0).all()
    tris, tv = P.marching_tetrahedra(tsdf, w, t(origin), voxel, min_weight=1.0, max_tris=50_000)
    tris = n(tris)[n(tv)]
    assert len(tris) > 200
    assert np.abs(tris[..., 2] - 4.0).max() < 2.1 * float(voxel)


def test_save_mesh_obj_is_byte_equal(tmp_path):
    tris = np.random.default_rng(0).uniform(-1, 1, (7, 3, 3)).astype(np.float32)
    a, b = tmp_path / "ref.obj", tmp_path / "port.obj"
    assert J.save_mesh_obj(str(a), tris) == P.save_mesh_obj(str(b), tris) == 7
    assert a.read_bytes() == b.read_bytes()
