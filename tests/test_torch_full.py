"""The FULL slice as a whole, on the CPU: the offline dense phase of the
port's System held to the reference's from one reference checkpoint, and
the port's retained keyframe images through its own checkpoint (FULL from
raw images on the port alone: tests/test_torch_full_drive.py).

(a) The reference's System(FULL) tracks a short rendered arc (the verify
capacities with 32 line slots, chunk 8) and writes a chunked checkpoint
with its retained keyframe images; the port loads it, so both offline
phases start from the same map and images. Tolerances: the keyframes and
their sweep neighbours exact; the edge pixels on >= 99.9 % of slots,
validity on >= 99 %, inverse depth to 1e-4 relative on >= 99 % of the
pixels valid in both (a last-bit difference can flip a discrete choice:
the sweep's best sample, the neighbour map's 3x3 probe, the chi2 gate; then
that pixel's depth moves by a sample or more: 41 of 8137 pixels measured);
the 3D segment count within 1 and segments to 1e-4 m as unordered pairs;
the triangle count within 0.5 % and the mean distance from a port vertex
to the nearest reference vertex under 0.1 voxel. On this arc the
reference itself fits 0 multi-view 3D segments and extracts 0 triangles
(its inter-keyframe check keeps ~20 % of the fused pixels, too sparse for
the 96^3 TSDF's two-view weight at all 8 corners of a cell), and so does
the port.
"""

from functools import lru_cache

import numpy as np
import pytest

import torch_parity  # noqa: F401  (one torch thread per test worker)

from eao_slam_torch.config import CapacityConfig, DemoFlag, tum3_config
from eao_slam_torch.system import System

N_FRAMES = 40
CAPACITY = dict(max_keyframes=64, max_points=4096, max_features=256, max_boxes=8,
                max_objects=16, local_ba_points=1024, max_lines=32)


@lru_cache(maxsize=None)
def arc():
    """tests/test_system_chunked.py's FULL fixture (cuboid faces shaded so
    their edges are detectable) on a 40-frame, 45-degree arc."""
    from eao_slam_torch.geometry.camera import TUM3
    from eao_slam_torch.io.synthetic import (
        FACE_SHADE_LINES, make_arc_trajectory, make_room_scene, project_boxes, render_image)

    scene = make_room_scene(seed=5, n_landmarks=200, n_objects=3, face_shade=FACE_SHADE_LINES)
    ts, gt = make_arc_trajectory(n_frames=N_FRAMES, sweep_deg=45.0)
    images = np.stack([render_image(scene, TUM3, T) for T in gt])
    return ts, gt, images, [project_boxes(scene, TUM3, T, 8) for T in gt]


def port_config():
    return tum3_config(DemoFlag.FULL).replace(capacity=CapacityConfig(**CAPACITY))


@lru_cache(maxsize=None)
def reference_run(path: str):
    """The reference's System(FULL) over the arc (each frame through
    frame_from_image and track_frame with its image), its checkpoint at
    ``path`` and its offline dense phase. Returns the reference System."""
    from eao_slam_tpu.config import CapacityConfig as JCap, DemoFlag as JFlag, tum3_config as jcfg
    from eao_slam_tpu.runtime.frame import frame_from_image
    from eao_slam_tpu.system import System as JSystem

    ts, _, images, boxes = arc()
    cfg = jcfg(JFlag.FULL).replace(capacity=JCap(**CAPACITY))
    ref = JSystem(cfg, chunk=8)
    for k in range(N_FRAMES):
        b, c, s, v = (np.asarray(x) for x in boxes[k])
        ref.track_frame(frame_from_image(cfg, images[k].astype(np.float32), boxes=b, box_class=c,
                                         box_score=s, box_valid=v), float(ts[k]), img=images[k])
    ref.save_checkpoint(path)
    ref.shutdown(semidense=True)
    return ref


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("full") / "reference_full.ckpt")
    ref = reference_run(path)
    port = System(port_config(), chunk=8, device="cpu")
    with pytest.warns(UserWarning, match="seeded afresh"):
        port.load_checkpoint(path)
    port.shutdown(semidense=True)
    return ref, port, path


def test_offline_phase_matches_the_reference_from_its_checkpoint(both):
    ref, port, _ = both
    assert port._semidense_slots == ref._semidense_slots and len(port._semidense_slots) >= 4
    assert port._semidense_neighbors(port._semidense_slots) == \
        ref._semidense_neighbors(ref._semidense_slots)
    rj, rp = ref._semidense_result, port._semidense_result
    pj, pp = np.asarray(rj.pixels), rp.pixels.numpy()
    same_px = np.abs(pj - pp).max(-1) == 0
    assert same_px.mean() >= 0.999
    vj, vp = np.asarray(rj.valid), rp.valid.numpy()
    assert (vj == vp).mean() >= 0.99, (vj == vp).mean()
    both_valid = vj & vp & same_px
    assert both_valid.sum() > 1000
    dj, dp = np.asarray(rj.inv_depth)[both_valid], rp.inv_depth.numpy()[both_valid]
    assert (np.abs(dp - dj) <= 1e-4 * np.abs(dj)).mean() >= 0.99

    lj, lp = ref._lines3d, port._lines3d
    assert abs(len(lj) - len(lp)) <= 1
    if len(lj) and len(lp):
        d = np.abs(lp[:, None] - lj[None]).max(-1)
        flip = np.abs(lp[:, None] - lj[None][..., [3, 4, 5, 0, 1, 2]]).max(-1)
        matched = np.minimum(d, flip).min(1)
        assert (matched < 1e-4).sum() >= min(len(lj), len(lp)) - 1

    tj, tp = ref._mesh_tris, port._mesh_tris
    assert abs(len(tp) - len(tj)) <= 0.005 * max(len(tj), 1)
    if len(tj) and len(tp):
        from eao_slam_torch.evaluation import nearest_neighbors

        pts = np.asarray(rj.points_w)[vj]
        voxel = float((np.percentile(pts, 98, 0) - np.percentile(pts, 2, 0) + 0.4).max() / 95)
        _, dist = nearest_neighbors(tp.reshape(-1, 3), tj.reshape(-1, 3), device="cpu")
        assert dist.mean() < 0.1 * voxel


def test_exports_match_the_references_format(both, tmp_path):
    ref, port, _ = both
    for name in ("save_semidense_obj", "save_lines_obj", "save_mesh_obj"):
        a, b = tmp_path / f"ref_{name}.obj", tmp_path / f"port_{name}.obj"
        n_ref, n_port = getattr(ref, name)(str(a)), getattr(port, name)(str(b))
        assert abs(n_port - n_ref) <= max(1, 0.01 * n_ref), name
        assert a.exists() == b.exists()
    assert port.save_semidense_obj(str(tmp_path / "sd.obj")) > 0


def test_port_checkpoint_round_trips_the_retained_images(both, tmp_path):
    """(c) The images the reference's file held come back from a file the
    port writes, in the reference's format."""
    _, port, ref_path = both
    path = str(tmp_path / "port_full.ckpt")
    port.save_checkpoint(path)
    data = np.load(path)
    assert data["kf_image_slots"].dtype == np.int32 and data["kf_images"].dtype == np.float32
    assert list(data["kf_image_slots"]) == sorted(port._kf_images)
    again = System(port_config(), chunk=8, device="cpu")
    again.load_checkpoint(path)
    ref_data = np.load(ref_path)
    assert sorted(again._kf_images) == [int(s) for s in ref_data["kf_image_slots"]]
    for j, s in enumerate(ref_data["kf_image_slots"]):
        np.testing.assert_array_equal(again._kf_images[int(s)], ref_data["kf_images"][j])
