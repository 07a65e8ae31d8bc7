"""The port's headless viewer against the reference's: the same state drawn
by both packages gives byte-equal PNG files.

The state is real: the reference's chunked tracker bootstrapped in EAO
mode on ``torch_parity.feature_sequence`` (its inner MonoTracker holds the
two-keyframe initial map), with three objects written into its object
table and some map points made their members. It crosses to the port as a
MonoTracker state (``convert.mono_tracker_from_numpy``) and as a chunked
carry (``convert.carry_from_numpy``). Checked byte for byte: the PNG
encoder, ``draw_frame`` (keypoints, a tracked mask, boxes, line segments,
the status bar), ``render_map`` (points, frusta, the covisibility graph,
the semi-dense cloud under its sigma gate, 3D lines, objects as cuboids
and quadrics, the follow camera), ``HeadlessViewer.update`` /
``finalize`` over both trackers; ``covisibility_counts`` and
``point_observation_counts`` exact. One divergence: the reference's
``finalize(system=...)`` passes the System's [M, 6] 3D line rows to
``render_map`` as they are and fails on them; the port draws them.
"""

import os
from functools import lru_cache

import numpy as np
import pytest
import torch

from eao_slam_torch import viz as tviz
from eao_slam_torch.convert import carry_from_numpy, mono_tracker_from_numpy
from eao_slam_torch.runtime.map_state import covisibility_counts, point_observation_counts
from eao_slam_torch.viz import map_drawer as tmd
from eao_slam_torch.viz import raster as traster
from eao_slam_tpu import viz as jviz
from eao_slam_tpu.runtime import map_state as jms
from eao_slam_tpu.viz import map_drawer as jmd
from eao_slam_tpu.viz import raster as jraster
from torch_parity import feature_sequence, jax_carry_numpy, jax_feature_bootstrap, jax_mono_numpy, n

CAP = dict(max_keyframes=64, max_points=4096, max_features=256, local_ba_points=1024,
           max_boxes=8, max_objects=16)
OBJECTS = ((56, (0.4, 0.2, 4.0), 0.0), (62, (-0.6, 0.1, 4.5), 0.3), (73, (0.0, -0.3, 3.6), -0.2))


def _cfgs():
    from eao_slam_torch.config import CapacityConfig as TC, tum3_config as tt
    from eao_slam_tpu.config import CapacityConfig as JC, tum3_config as jt

    return jt("EAO").replace(capacity=JC(**CAP)), tt("EAO").replace(capacity=TC(**CAP))


def _with_objects(table: dict, m: dict) -> tuple:
    """Three live objects (a chair and a book drawn as cuboids, a tv as a
    quadric) and a fourth marked bad, with every fifth live map point a
    member of one of them."""
    table = {k: np.array(v) for k, v in table.items()}
    m = {k: np.array(v) for k, v in m.items()}
    for j, (cls, c, yaw) in enumerate(OBJECTS + ((56, (9.0, 9.0, 9.0), 0.0),)):
        table["valid"][j] = True
        table["bad"][j] = j == 3
        table["cls"][j] = cls
        table["center"][j] = c
        table["cub_min"][j] = (-0.2, -0.15, -0.25)
        table["cub_max"][j] = (0.25, 0.15, 0.2)
        table["yaw"][j] = yaw
    live = np.flatnonzero(m["pt_valid"])
    m["pt_object_id"][live[::5]] = np.arange(len(live[::5])) % 3
    return table, m


@lru_cache(maxsize=None)
def reference_state():
    jcfg, _ = _cfgs()
    tr, i = jax_feature_bootstrap(jcfg)
    mono = jax_mono_numpy(tr.inner)
    mono["obj_table"], mono["map"] = _with_objects(mono["obj_table"], mono["map"])
    carry = jax_carry_numpy(tr.carry, with_table=True)
    carry["table"], carry["m"] = _with_objects(carry["table"], carry["m"])
    return mono, carry, i


def mono_pair():
    from eao_slam_torch.runtime.tracker import MonoTracker
    from torch_parity import jax_mono_from_numpy

    jcfg, tcfg = _cfgs()
    mono, _, _ = reference_state()
    j = jax_mono_from_numpy(mono, jcfg)
    t = mono_tracker_from_numpy(mono, MonoTracker(tcfg, torch.device("cpu")))
    return j, t


def chunked_pair():
    import jax.numpy as jnp

    from eao_slam_torch.runtime.scan_tracker import ChunkedTracker
    from eao_slam_tpu.objects.state import ObjectTable
    from eao_slam_tpu.runtime.map_state import MapState

    jcfg, tcfg = _cfgs()
    _, carry, _ = reference_state()
    j, _ = jax_feature_bootstrap(jcfg)
    j.carry = j.carry._replace(
        m=MapState(**{k: jnp.asarray(v) for k, v in carry["m"].items()}),
        table=ObjectTable(**{k: jnp.asarray(v) for k, v in carry["table"].items()}))
    t = ChunkedTracker(tcfg, chunk=5, device="cpu")
    t.carry = carry_from_numpy(carry, "cpu")
    t.state_host = j.state
    return j, t


def frame_pair():
    """One frame of the sequence in both packages, with its boxes, some
    line segments and a tracked mask; its rendered image."""
    from eao_slam_torch.geometry.camera import TUM3
    from eao_slam_torch.io.synthetic import make_room_scene, project_boxes, render_image
    from eao_slam_torch.runtime.frame import frame_from_arrays as t_frame
    from eao_slam_tpu.runtime.frame import frame_from_arrays as j_frame

    jcfg, tcfg = _cfgs()
    ts, gt, obs = feature_sequence()
    k = reference_state()[2]
    o = obs[k]
    scene = make_room_scene(seed=3, n_landmarks=1200, n_objects=3)
    boxes = project_boxes(scene, TUM3, gt[k], CAP["max_boxes"])
    rng = np.random.default_rng(1)
    lines = np.zeros((jcfg.capacity.max_lines, 4), np.float32)
    lines[:12] = rng.uniform((0, 0, 0, 0), (640, 480, 640, 480), (12, 4))
    line_valid = np.arange(len(lines)) < 10
    kw = dict(kp=o["kp"], desc=o["desc"], octave=o["octave"], valid=o["valid"])
    jf = j_frame(jcfg, **kw, boxes=boxes[0], box_class=boxes[1], box_score=boxes[2],
                 box_valid=boxes[3], lines=lines, line_valid=line_valid)
    tf = t_frame(tcfg, **kw, boxes=boxes, lines=lines, line_valid=line_valid)
    tracked = o["valid"] & (rng.random(len(o["valid"])) < 0.6)
    return jf, tf, tracked, render_image(scene, TUM3, gt[k]), gt[k]


def test_png_encoder_and_primitives_equal():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    assert traster.encode_png(img) == jraster.encode_png(img)
    assert traster.encode_png(img[..., 0]) == jraster.encode_png(img[..., 0])
    canvases = []
    for r in (traster, jraster):
        rng = np.random.default_rng(1)
        c = r.blank_canvas(60, 80)
        r.draw_segments(c, rng.uniform(-20, 100, (5, 2)), rng.uniform(-20, 100, (5, 2)),
                        thickness=2)
        r.draw_circles(c, np.array([[10.5, 20.2], [70.0, 50.0]]), radius=4)
        r.draw_rects(c, np.array([[5, 5, 30, 20]]), color=(1, 2, 3))
        r.draw_text(c, (2, 40), "slam mode: 12%", scale=2)
        canvases.append(r.encode_png(c))
    assert canvases[0] == canvases[1]


def test_draw_frame_equal():
    jf, tf, tracked, img, _ = frame_pair()
    for kw in ({}, {"tracked_mask": tracked, "n_tracked": int(tracked.sum())},
               {"show_lines": False, "state": 3}):
        want = jviz.draw_frame(img, jf, **kw)
        got = tviz.draw_frame(torch.as_tensor(img), tf, **kw)
        assert got.dtype == np.uint8 and got.shape == want.shape
        assert traster.encode_png(got) == jraster.encode_png(want)
    assert np.array_equal(tviz.draw_frame(img, None, state=1), jviz.draw_frame(img, None, state=1))


def test_map_counts_exact():
    for j, t in (mono_pair(), chunked_pair()):
        jm, tm = j.map, t.map
        C = n(covisibility_counts(tm))
        np.testing.assert_array_equal(C, np.asarray(jms.covisibility_counts(jm)))
        np.testing.assert_array_equal(n(point_observation_counts(tm)),
                                      np.asarray(jms.point_observation_counts(jm)))
        assert C.dtype == np.int32 and C.max() > 15      # the graph has edges to draw


def test_render_map_equal():
    j, t = mono_pair()
    rng = np.random.default_rng(2)
    sd = rng.normal((0, 0, 4), 1.0, (500, 3))
    sigma = rng.uniform(0, 0.2, 500)
    l3 = rng.normal((0, 0, 4), 1.0, (6, 2, 3))
    T = np.asarray(j.map.kf_pose[j.kf_slots[-1]])
    covis = np.asarray(jms.covisibility_counts(j.map))
    for kw in (dict(), dict(cur_T_cw=T), dict(semidense_pts=sd, semidense_sigma=sigma, lines3d=l3),
               dict(T_view=jmd.look_at(np.array([1.0, -2.0, -3.0]), np.zeros(3)))):
        want = jmd.render_map(j.map, objects=j.obj_table, covis=covis, **kw)
        got = tmd.render_map(t.map, objects=t.obj_table, covis=torch.as_tensor(covis),
                             **{k: torch.as_tensor(v) for k, v in kw.items()})
        assert traster.encode_png(got) == jraster.encode_png(want), list(kw)
    opt_t = tmd.MapRenderOptions(show_cubes=False, class_filter=frozenset({62, 73}),
                                 width=320, height=240)
    opt_j = jmd.MapRenderOptions(show_cubes=False, class_filter=frozenset({62, 73}),
                                 width=320, height=240)
    assert np.array_equal(tmd.render_map(t.map, objects=t.obj_table, opt=opt_t),
                          jmd.render_map(j.map, objects=j.obj_table, opt=opt_j))


def _viewer_files(viewer_module, tracker, out, frame=None, img=None, T=None):
    v = viewer_module.HeadlessViewer(str(out), viewer_module.ViewerOptions(every=2))
    for k in range(3):
        v.update(tracker, frame=frame, img=img, T_cw=T, n_tracked=40 + k)
    v.finalize(tracker=tracker)
    return {os.path.basename(p): open(p, "rb").read() for p in v.written}


@pytest.mark.parametrize("kind", ["mono", "chunked"])
def test_headless_viewer_equal(kind, tmp_path):
    j, t = mono_pair() if kind == "mono" else chunked_pair()
    jf, tf, _, img, T = frame_pair()
    got = _viewer_files(tviz, t, tmp_path / "port", tf, img, torch.as_tensor(T))
    want = _viewer_files(jviz, j, tmp_path / "ref", jf, img, T)
    assert sorted(got) == sorted(want) == ["frame_000000.png", "frame_000002.png",
                                           "map_000000.png", "map_000002.png", "map_final.png"]
    for name in got:
        assert got[name] == want[name], name


def test_finalize_draws_a_systems_3d_lines_where_the_reference_fails(tmp_path):
    """A System's 3D lines are [M, 6] rows; the reference's viewer hands
    them to render_map unchanged, which takes [M, 2, 3] and fails; the port
    reshapes them and draws the same picture as [M, 2, 3] lines given
    directly."""
    from types import SimpleNamespace

    j, t = mono_pair()
    rows = np.random.default_rng(3).normal((0, 0, 4, 0, 0, 4), 1.0, (2, 6))
    with pytest.raises(ValueError):
        jviz.HeadlessViewer(str(tmp_path / "ref")).finalize(
            system=SimpleNamespace(tracker=j, _semidense_result=None, _lines3d=rows))
    v = tviz.HeadlessViewer(str(tmp_path / "port"))
    path = v.finalize(system=SimpleNamespace(tracker=t, _semidense_result=None, _lines3d=rows))
    direct = tviz.HeadlessViewer(str(tmp_path / "direct")).finalize(
        tracker=t, lines3d=rows.reshape(-1, 2, 3))
    assert open(path, "rb").read() == open(direct, "rb").read()
