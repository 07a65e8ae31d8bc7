"""Spread of the JAX reference's bench-arc ATE over RANSAC seeds, on the CPU.

    JAX_PLATFORMS=cpu python reference_ate_spread.py [--flag EAO] [--seeds 12345 1 2 3 4 5 6]
    JAX_PLATFORMS=cpu python reference_ate_spread.py --flag LineAndiForest --seeds ...
    JAX_PLATFORMS=cpu python reference_ate_spread.py --flag LineAndiForest --ground --seeds ...
    JAX_PLATFORMS=cpu python reference_ate_spread.py --replay-yaw DIR/yaw_calls_seed5.npz ...
    JAX_PLATFORMS=cpu python reference_ate_spread.py --dense
    JAX_PLATFORMS=cpu python reference_ate_spread.py --interactive [--flag EAO] [--modes] \
        --seeds ...
    JAX_PLATFORMS=cpu python reference_ate_spread.py --interactive --eager --seeds ...
    JAX_PLATFORMS=cpu python reference_ate_spread.py --interactive --record-init DIR --seeds ...
    JAX_PLATFORMS=cpu python reference_ate_spread.py --interactive --port-orb --seeds ...
    JAX_PLATFORMS=cpu python reference_ate_spread.py --interactive --lockstep --seeds ...
    JAX_PLATFORMS=cpu python reference_ate_spread.py --interactive --stage-audit --seeds ...
    JAX_PLATFORMS=cpu python reference_ate_spread.py --cli
    JAX_PLATFORMS=cpu python reference_ate_spread.py --cli-test DIR [--scenes 4 5 ...] \
        [--record-init DIR] --seeds ...
    JAX_PLATFORMS=cpu python reference_ate_spread.py --cli-test DIR --init-rates N [--scenes ...]

Runs the reference package (eao_slam_tpu) as bench.py's headline mode
does (``--flag None``, the default) or its EAO mode (``--flag EAO``, or
another flag of the object layer), at bench.py's capacities on its
rendered 60-degree arc of 168 frames: bootstrap, a warm-up chunk, four
timed chunks of 32 frames. Loop closing is off: on this arc it closes no
loop (chip_smoke.py, loop closing on, closes none either). Only
``SystemConfig.seed`` changes between runs; it seeds the two-view
initializer's RANSAC draws. A seed whose bootstrap takes more than 8
frames gets a shorter (padded) warm-up chunk, so that the timed chunks
still fit the arc; for the others this is bench.py's protocol exactly
(chip_smoke.py follows the same rule). In an object mode every chunk goes
through ``ChunkedTracker.track_images`` with bench.py's boxes
(``project_boxes``, 8 a frame), so the object merge pass runs after each
chunk, as it does in the port's System. For each seed it prints one JSON
line with the frames tracked and the sim3 ATE of the timed trajectory (in
an object mode also the objects built and each scene object's centre
error: in the camera frames of the keyframes that observed the object, at
the map's scale, ``eao_slam_torch.io.trajectory.map_object_errors``; and,
for comparison, after one sim3 of the keyframe trajectory,
``sim3_object_errors``), then the median and the worst. With
``--flag LineAndiForest`` (line detection inside the chunk program and
line-alignment yaw) each live object's elected yaw and its yaw votes are
printed beside the object errors (``object_yaws``); the scene's cuboids
are axis-aligned in the first camera's frame, so the true yaw is 0. In an
object mode each live object's class, member points and cuboid extent per
axis in map units are printed too (``object_extents``, chip_smoke.py's). In
line mode the frames of a chunk go through ``frame_from_image`` one at a
time (ORB features and line segments) and the chunk through
``ChunkedTracker.track_batch``: the fused program of ``track_images``
holds a one-hot occupancy of [32, 16, 10, 128, 19200] for the line
endpoints, tens of GB on a CPU host. The JAX line detector costs about a
second a frame on the CPU: run seeds as parallel processes, each with
about 4 GB. ``--ground`` runs chip_smoke.py's ground-alignment protocol
instead: the first TILT_FRAMES frames of the arc with every camera tilted,
the ground truth written by the reference's ``save_tum`` and looked up per
bootstrap frame as the reference's ``System.set_groundtruth`` does, every
frame tracked; it prints the first keyframe's distance from the
initializer frame's true T_cw and the objects' yaws and votes.
``--replay-yaw FILE ...`` runs no tracker: it takes the yaw calls that
``port_ate_spread.py --record-yaw`` recorded from a run of the port and
puts each call's inputs through the reference's ``yaw_sample_scores`` and
then ``update_yaw`` (on the reference's own scores), and prints one JSON
line a file: the calls whose counts or lines in box differ from the port's
(exact), the largest differences of the summed errors and of ``yaw_hist``,
the calls whose elected yaws differ by more than 1e-6 rad, and, for each
object valid at the last call, the yaw the port and the reference elect
there, its votes by yaw sample and the mean score of each voted sample.
``--dense`` runs bench.py's dense protocol (``_semidense_numbers``) once:
DemoFlag.FULL over the first DENSE_FRAMES frames of the arc (8 + 2 x 32)
at the line phase's capacities, each frame through ``frame_from_image``
and ``System.track_frame(..., img=)`` (the keyframe images are kept), then
``System.shutdown(semidense=True)``; it prints the keyframes, the seconds
on the host clock, the valid semi-dense points, the 3D segments, the
triangles, and the cloud's quality: the semi-dense export against the
ray-cast depth of the retained keyframes at their true poses (every 8th
pixel, ``eao_slam_torch.io.synthetic.depth_cloud``), in the camera frame
of the map's first keyframe, by the reference's
``evaluation.evaluate_reconstruction`` as it is, and by its scaled ICP
started from the sim3 of the keyframe centres onto their true centres
(the mean distance, which far outliers dominate, and the median).
chip_smoke.py prints these figures beside the port's (about 10 minutes
and 4 GB on the CPU).

``--interactive`` runs the interactive per-frame tracker instead:
``System(cfg, chunked=False)`` at the same capacities with loop closing
and the BoW vocabulary on (the configuration's defaults), every frame of
the arc through ``track_monocular`` (with the boxes in an object mode),
through chip_smoke.py's ``drive_interactive``: it prints the frame that
initialized, the frames tracked after it, the sim3 ATE of every tracked
frame, the keyframes and points, whether the vocabulary was trained and
holds every live keyframe (and the objects in an object mode), then the
median and the worst. With ``--modes`` each geometry run goes on through
``interactive_modes``: the kidnap (blank frames, then the frames from 40,
relocalization within 5 frames and its error), localization mode over
frames 60-91 and a reset. About 10 minutes a seed on one core. Each
interactive run also prints the live points at the end, the points each
keyframe's triangulations added and each two-view initialization attempt
(frame, success, points; ``port_ate_spread.py``'s helpers).
``--record-init DIR`` keeps, at every ``initialize_two_view`` call, the
hypothesis indices the reference draws there (``jax.random.choice`` of
``solvers/init2view.py`` on the key the tracker split for the call,
recomputed in a jitted program of the same operations) with the
valid-match mask they were drawn over and the attempt's inputs (the
matched pixels ``uv1`` / ``uv2``, the key, sigma and
``min_triangulated``), and writes them to
``DIR/init_draws_seed<seed>.npz`` for ``port_ate_spread.py
--replay-init`` (tests/init2view_seed4_frame4.npz is one attempt of such
a file). ``--port-orb`` feeds the reference's MonoTracker the
port's front end instead of its own: each frame's ORB features from
``eao_slam_torch.runtime.frame.frame_from_image`` on the CPU (computed once
for all seeds), through ``System.track_frame``; the reference's tracker on
the port's features. ``--lockstep [--frames N]`` runs no spread: the
reference tracks the first N frames (100 by default) of each seed's arc,
and before every frame after initialization its state crosses to the
port (``convert.mono_tracker_from_numpy``), which takes the same step from
it on the reference's own Frame; per frame it prints whether each made a
keyframe, the tracked points, the live points, the points the step
created, the observations and the pose difference, then their totals:
whether any tracker stage differs from one state along a whole run; and,
element by element (``step_sets_differ``), the keyframe choice, the
features whose tracked point differs, the points created or culled by one
package and not the other and the observation slots that differ, with
the first step where any of them does. ``--stage-audit [--frames N]``
runs the reference alone over the first N frames and puts each of its
keyframe triangulations and each motion model's pose LM (on the matches
the motion model finds) through the port on the same inputs, the LM also
in float64: the triangulations whose accepted points differ, and how far
each package's float32 LM lies from the float64 result (medians, which
is nearer how often, inlier flips): whether a stage decides otherwise
on equal inputs, or only float32 rounding parts them.

``--cli`` runs the reference's ``mono_tum`` driver as chip_smoke.py's
command-line phase runs the port's: the arc's frames (rendered by the
reference) written as a TUM directory with its ground truth and the bench
boxes as offline detections (``chip_smoke.write_tum_sequence``), then
``eao_slam_tpu.cli.run_mono_tum("EAO", ...)``; it prints the figures
chip_smoke.py gates on (``chip_smoke.cli_figures``: the frame that
initialized, the share tracked after it, the sim3 ATE of
FrameTrajectory.txt, the objects' classes, the exports) with the run's
statistics and seconds. About 5 minutes on the CPU.

``--cli-test DIR`` runs the reference's ``run_mono_tum("EAO", ...)`` on
tests/test_cli.py's 26-frame sequence per scene seed of ``--scenes`` and
RANSAC seed of ``--seeds``, on the files ``port_ate_spread.py --cli-test
DIR`` writes (``port_ate_spread.write_cli_test_sequence``: the two
packages read the same PNGs), with the same figures per run
(``port_ate_spread.cli_test_run``); ``--record-init DIR2`` writes each
run's init draws to DIR2/``cli_init_draws_scene<S>_seed<R>.npz`` for
``port_ate_spread.py --cli-test DIR --replay-init DIR2``. With
``--init-rates N`` it runs no ``run_mono_tum``: per scene, each package's front end
and ``match_for_init`` on frames 0 and k = 1, 2, 3, then N hypothesis
draws of each attempt (keys 5000 to 5000 + N - 1): the reference's
``initialize_two_view`` on its matches with the key, the port's on its own
matches with the reference's draw for its mask (``init_draw``); it prints
how many of the N succeed in each package.

This is the yardstick that chip_smoke.py's ATE gate is derived from: the
tracker is chaotic (float noise in one triangulation changes later
keyframe decisions), so one run's ATE is a draw from this spread.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

CHUNK = 32
N_TIMED = 4
N_FRAMES = 8 + CHUNK * (1 + N_TIMED)
N_BOXES = 8
DENSE_FRAMES = 8 + 2 * CHUNK


def warmup_frames(n_boot: int) -> int:
    """One chunk after the bootstrap, cut so the timed chunks fit the arc."""
    return min(CHUNK, N_FRAMES - N_TIMED * CHUNK - n_boot)


def centers(x):
    return np.einsum("nij,ni->nj", -x[:, :3, :3], x[:, :3, 3])


def run(seed: int, images, ts, gt, flag: str = "None", boxes=None, scene=None) -> dict:
    import jax.numpy as jnp

    from eao_slam_tpu.config import CapacityConfig, TrackingConfig, tum3_config
    from eao_slam_tpu.io.trajectory import ate_rmse
    from eao_slam_tpu.runtime.frame import frame_from_image
    from eao_slam_tpu.runtime.scan_tracker import (
        ChunkedTracker, batch_from_frames, make_extract_track)
    from chip_smoke import object_extents
    from eao_slam_torch.io.trajectory import map_object_errors, object_yaws, sim3_object_errors

    objects = flag != "None"
    cap = CapacityConfig(max_keyframes=128, max_points=8192, max_features=1024,
                         local_ba_points=2048,
                         **(dict(max_boxes=N_BOXES, max_objects=32) if objects else {}))
    cfg = tum3_config(flag).replace(capacity=cap, seed=seed,
                                    tracking=TrackingConfig(enable_loop_closing=False))
    tracker = ChunkedTracker(cfg, chunk=CHUNK)
    extract_track = make_extract_track(cfg, tracker._track_chunk)

    def box_kw(lo, hi):
        if not objects:
            return {}
        return dict(zip(("boxes", "box_class", "box_score", "box_valid"),
                        (b[lo:hi] for b in boxes)))

    def frame(k):
        kw = {key: v[0] for key, v in box_kw(k, k + 1).items()}
        return frame_from_image(cfg, images[k].astype(np.float32), **kw)

    def track(lo, hi):
        if not cfg.flag.use_yaw_lines:
            return tracker.track_images(images[lo:hi], ts[lo:hi], **box_kw(lo, hi))
        frames = [frame(k) for k in range(lo, hi)]
        n = hi - lo
        batch = batch_from_frames(frames + [frames[-1]] * (CHUNK - n),
                                  list(ts[lo:hi]) + [ts[hi - 1]] * (CHUNK - n), with_boxes=True)
        if n < CHUNK:
            batch = batch._replace(active=jnp.asarray(np.arange(CHUNK) < n))
        return tracker.track_batch(batch)

    i = 0
    while tracker.carry is None:
        tracker.bootstrap(frame(i), float(ts[i]))
        i += 1
    n_boot = i
    n_warm = warmup_frames(n_boot)
    assert n_warm > 0, f"bootstrap took {n_boot} frames"
    track(i, i + n_warm)
    carry = tracker.carry
    i += n_warm
    poses, states = [], []
    for _ in range(N_TIMED):
        if objects:
            outs = track(i, i + CHUNK)
        else:
            carry, outs = extract_track(carry, jnp.asarray(images[i:i + CHUNK]),
                                        jnp.asarray(ts[i:i + CHUNK], jnp.float32))
        poses.append(np.asarray(outs.T))
        states.append(np.asarray(outs.state))
        i += CHUNK
    T = np.concatenate(poses)
    ok = np.concatenate(states) == 2
    g = gt[i - N_TIMED * CHUNK:i]

    ate = ate_rmse(centers(T[ok]), centers(g[ok]), with_scale=True)
    out = {"seed": seed, "flag": flag, "bootstrap_frames": n_boot, "tracked": int(ok.sum()),
           "total": int(ok.size), "ate_m": float(ate)}
    if objects:
        tab = {k: np.asarray(v) for k, v in tracker.carry.table._asdict().items()}
        m = {k: np.asarray(v) for k, v in tracker.carry.m._asdict().items()}
        live = tab["valid"] & ~tab["bad"]
        out["objects"] = int(live.sum())
        out["object_keyframes"] = int(m["kf_by_object"].sum())
        out["object_classes"] = sorted(int(c) for c in tab["cls"][live])
        out["object_centre_err_m"] = map_object_errors(m, tab, ts, gt, scene.obj_centers,
                                                       scene.obj_classes)
        out["object_centre_err_sim3_m"] = sim3_object_errors(m, tab, ts, gt, scene.obj_centers)
        out["object_yaws"] = object_yaws(tab)
        out["object_extents"] = object_extents(m, tab)
    return out


def init_draw(valid, key):
    """The hypothesis indices ``initialize_two_view`` draws from ``key``
    over the valid matches (``solvers/init2view.py``, n_hyp 256)."""
    import jax
    import jax.numpy as jnp

    p = valid.astype(jnp.float32) / jnp.maximum(jnp.sum(valid), 1)
    return jax.random.choice(key, valid.shape[0], shape=(256, 8), p=p)


def port_orb_frames(images) -> list:
    """The port's front end on every image, on the CPU, as numpy arrays
    (descriptors as uint32) for the reference's frame_from_arrays."""
    import torch

    from eao_slam_torch.config import CapacityConfig, tum3_config
    from eao_slam_torch.runtime.frame import frame_from_image

    cfg = tum3_config().replace(capacity=CapacityConfig(
        max_keyframes=128, max_points=8192, max_features=1024, local_ba_points=2048))
    out = []
    for img in images:
        f = frame_from_image(cfg, img, torch.device("cpu"))
        out.append({"kp": f.kp.numpy(), "desc": f.desc.numpy().view(np.uint32),
                    "octave": f.octave.numpy(), "angle": f.angle.numpy(),
                    "valid": f.valid.numpy()})
    return out


def lockstep_run(seed: int, images, ts, n_frames: int) -> dict:
    """The reference and the port one step apart (see the module
    docstring)."""
    import copy

    import torch

    from eao_slam_torch.config import CapacityConfig as TC, tum3_config as tt
    from eao_slam_torch.convert import (frame_from_numpy, mono_tracker_from_numpy,
                                        mono_tracker_to_numpy)
    from eao_slam_torch.runtime.tracker import MonoTracker as PortMono
    from eao_slam_tpu.config import CapacityConfig, tum3_config
    from eao_slam_tpu.runtime.frame import frame_from_image
    from eao_slam_tpu.runtime.tracker import MonoTracker
    from tests.torch_parity import jax_mono_numpy

    cap = dict(max_keyframes=128, max_points=8192, max_features=1024, local_ba_points=2048)
    ref = MonoTracker(tum3_config().replace(capacity=CapacityConfig(**cap), seed=seed))
    pcfg = tt().replace(capacity=TC(**cap), seed=seed)
    keys = ("kf", "tracked", "points", "new", "observations")
    steps = []
    for k in range(n_frames):
        fr = frame_from_image(ref.cfg, images[k].astype(np.float32))
        before = jax_mono_numpy(ref) if ref.state == 2 else None
        T = ref.track(fr, float(ts[k]))
        if before is None:
            continue
        port = mono_tracker_from_numpy(copy.deepcopy(before), PortMono(pcfg, torch.device("cpu")))
        Tp = port.track(frame_from_numpy({f: np.asarray(getattr(fr, f)) for f in fr._fields},
                                         "cpu"), float(ts[k]))
        row = {"frame": k}
        for tag, d in (("ref", jax_mono_numpy(ref)), ("port", mono_tracker_to_numpy(port))):
            kf = d["kf_slots"][-1] not in before["kf_slots"]
            row[tag] = dict(zip(keys, (
                kf, None if d["last_pt"] is None else int((np.asarray(d["last_pt"]) >= 0).sum()),
                int(d["pt_valid_host"].sum()),
                int((d["pt_valid_host"] & (d["pt_first_kf_host"] == d["kf_slots"][-1])).sum())
                if kf else 0,
                int((d["kf_pt_host"] >= 0).sum()))))
        row["pose_diff"] = (None if T is None or Tp is None
                            else float(np.abs(np.asarray(T) - np.asarray(Tp)).max()))
        row["sets_differ"] = step_sets_differ(before, jax_mono_numpy(ref),
                                              mono_tracker_to_numpy(port))
        steps.append(row)
        print(json.dumps(row), flush=True)
    differ = [r["frame"] for r in steps if r["ref"] != r["port"]]
    sets = [r["frame"] for r in steps if any(r["sets_differ"].values())]
    return {"seed": seed, "lockstep": True, "steps": len(steps),
            "keyframe_steps": sum(r["ref"]["kf"] for r in steps),
            "steps_whose_counts_differ": differ,
            "steps_whose_sets_differ": sets,
            "first_set_difference": next((r for r in steps if r["frame"] in sets), None),
            "max_pose_diff": max((r["pose_diff"] or 0.0) for r in steps),
            "totals": {tag: {k: sum(int(r[tag][k] or 0) for r in steps) for k in keys}
                       for tag in ("ref", "port")},
            "set_differences": {k: sum(r["sets_differ"][k] for r in steps)
                                for k in steps[0]["sets_differ"]} if steps else {}}


def step_sets_differ(before: dict, ref: dict, port: dict) -> dict:
    """The discrete decisions of one step taken by both packages from the
    state ``before`` (``jax_mono_numpy`` / ``mono_tracker_to_numpy``
    dicts), element by element rather than by count. A point created in
    the step is known by the keyframe feature it came from (the two may put
    it in other slots); an older point by its slot. Counts: whether the
    keyframe choice differs; the features whose tracked point (``last_pt``,
    the pose's inlier set) differs; the keyframe features that got a new
    point in one package only (``created``); the older points one package
    culled and the other kept (``culled``); the keyframe features whose
    older point, or whether it has one, differs (``observations``)."""
    def kf(d):
        return d["kf_slots"][-1] not in before["kf_slots"]

    v0 = np.asarray(before["pt_valid_host"])

    def old(x):
        x = np.asarray(x)
        return (x >= 0) & v0[np.clip(x, 0, len(v0) - 1)]

    out = {"keyframe": int(kf(ref) != kf(port)), "inliers": 0}
    if ref["last_pt"] is not None and port["last_pt"] is not None:
        a, b = np.asarray(ref["last_pt"]), np.asarray(port["last_pt"])
        out["inliers"] = int((((a >= 0) != (b >= 0)) | (old(a) & old(b) & (a != b))).sum())
    ra, pa = np.asarray(ref["kf_pt_host"]), np.asarray(port["kf_pt_host"])
    out["created"] = int((((ra >= 0) & ~old(ra)) != ((pa >= 0) & ~old(pa))).sum())
    out["culled"] = int(((v0 & ~ref["pt_valid_host"]) != (v0 & ~port["pt_valid_host"])).sum())
    out["observations"] = int(((old(ra) != old(pa)) | (old(ra) & old(pa) & (ra != pa))).sum())
    return out


def stage_audit(seed: int, images, ts, n_frames: int) -> dict:
    """The reference tracks the first ``n_frames`` of the arc; each
    keyframe triangulation (``triangulate_with_neighbor``) and each motion
    model's pose LM (``optimize_pose`` on the matches that
    ``track_motion_model`` finds) also runs on the same inputs in the port,
    the LM in float32 and in float64. Returns the triangulations and
    points whose acceptance differs, those points' least depth in the two
    views (either package's point), the parallax cosine of those deeper
    than 0.1 map units and the largest distance between the packages'
    points there; and each LM's pose distance from the port's float64
    result (medians, which package lies nearer how often) and its inlier
    flips."""
    import jax
    import jax.numpy as jnp
    import torch

    from eao_slam_torch.geometry.camera import TUM3 as PORT_TUM3
    from eao_slam_torch.runtime import local_mapping as port_lm
    from eao_slam_torch.solvers import pose_lm as port_pose
    from eao_slam_tpu.config import CapacityConfig, tum3_config
    from eao_slam_tpu.geometry import se3
    from eao_slam_tpu.geometry.camera import in_image, project
    from eao_slam_tpu.ops import matching
    from eao_slam_tpu.runtime import tracker as jtracker, tracking_kernels as tk
    from eao_slam_tpu.runtime.frame import frame_from_image
    from eao_slam_tpu.solvers import pose_lm

    def port(a, f64=False):
        a = np.asarray(a)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        return torch.as_tensor(np.array(a, np.float64 if f64 and a.dtype == np.float32
                                        else a.dtype))

    tri, lms, parted_pts, moved = [], [], [], []
    tri_fn, mm_fn, lm = jtracker.triangulate_with_neighbor, tk.track_motion_model, jax.jit(
        pose_lm.optimize_pose, static_argnums=0)

    def tri_spy(cam, *args):
        out = tri_fn(cam, *args)
        p = port_lm.triangulate_with_neighbor(PORT_TUM3, *(port(a) for a in args))
        parted = np.flatnonzero(np.asarray(out.good) != p.good.numpy())
        tri.append([int(np.asarray(out.good).sum()), len(parted)])
        T1, T2 = (np.asarray(args[i], np.float64) for i in (0, 6))
        for X in (np.asarray(out.points)[parted], p.points.numpy()[parted]):
            X = X.astype(np.float64)
            depth = np.minimum((X @ T1[:, :3].T + T1[:, 3])[:, 2], (X @ T2[:, :3].T + T2[:, 3])[:, 2])
            c1, c2 = X + T1[:, :3].T @ T1[:, 3], X + T2[:, :3].T @ T2[:, 3]
            cos = (c1 * c2).sum(-1) / (np.linalg.norm(c1, axis=-1) * np.linalg.norm(c2, axis=-1))
            parted_pts.extend(zip(depth.tolist(), cos.tolist()))
        if len(parted):
            moved.append(float(np.abs(np.asarray(out.points)[parted]
                                      - p.points.numpy()[parted]).max()))
        return out

    def mm_spy(cam, pt_pos, pt_valid, T_pred, last_kp, last_desc, last_octave, last_angle,
               last_valid, last_pt, kp, desc, octave, angle, valid, scale2, radius=15.0):
        out = mm_fn(cam, pt_pos, pt_valid, T_pred, last_kp, last_desc, last_octave, last_angle,
                    last_valid, last_pt, kp, desc, octave, angle, valid, scale2, radius=radius)
        Xw = pt_pos[jnp.clip(last_pt, 0, pt_pos.shape[0] - 1)]
        xc = se3.apply(T_pred, Xw)
        proj = project(cam, xc)
        q = (last_valid & (last_pt >= 0) & pt_valid[jnp.clip(last_pt, 0, pt_pos.shape[0] - 1)]
             & (xc[..., 2] > 0.05) & in_image(cam, proj))
        lv = jnp.clip(last_octave, 0, scale2.shape[0] - 1)
        idx, _, ok = matching.search_by_projection(
            proj, last_octave, last_desc, q, kp, octave, desc, valid,
            radius * jnp.sqrt(scale2)[lv], query_angle=last_angle, kp_angle=angle,
            max_dist=matching.TH_HIGH, ratio=0.9, check_rotation=True)
        args = [np.asarray(x) for x in (T_pred, Xw, kp[idx], 1.0 / scale2[jnp.clip(
            octave[idx], 0, scale2.shape[0] - 1)], ok)]
        r = lm(cam, *(jnp.asarray(a) for a in args))
        p32 = port_pose.optimize_pose(PORT_TUM3, *(port(a) for a in args))
        p64 = port_pose.optimize_pose(PORT_TUM3, *(port(a, True) for a in args))
        T64 = p64.T.numpy()
        lms.append([float(np.abs(np.asarray(r.T) - T64).max()),
                    float(np.abs(p32.T.numpy() - T64).max()),
                    int((np.asarray(r.inliers) != p64.inliers.numpy()).sum()),
                    int((p32.inliers.numpy() != p64.inliers.numpy()).sum())])
        return out

    cap = dict(max_keyframes=128, max_points=8192, max_features=1024, local_ba_points=2048)
    ref = jtracker.MonoTracker(tum3_config().replace(capacity=CapacityConfig(**cap), seed=seed))
    jtracker.triangulate_with_neighbor, tk.track_motion_model = tri_spy, mm_spy
    try:
        for k in range(n_frames):
            ref.track(frame_from_image(ref.cfg, images[k].astype(np.float32)), float(ts[k]))
    finally:
        jtracker.triangulate_with_neighbor, tk.track_motion_model = tri_fn, mm_fn
    t, m = np.array(tri), np.array(lms)
    return {"seed": seed, "stage_audit": True, "triangulations": len(t),
            "triangulated_points": int(t[:, 0].sum()), "triangulations_that_differ":
            int((t[:, 1] > 0).sum()), "points_that_differ": int(t[:, 1].sum()),
            "their_depth_min_max": [min(d for d, _ in parted_pts), max(d for d, _ in parted_pts)]
            if parted_pts else None,
            "their_parallax_cos": sorted({round(c, 5) for d, c in parted_pts if d > 0.1}),
            "their_largest_move": max(moved, default=0.0), "pose_lms": len(m),
            "median_dist_from_float64": {"reference": float(np.median(m[:, 0])),
                                         "port": float(np.median(m[:, 1]))},
            "nearer_float64": {"reference": int((m[:, 0] < m[:, 1]).sum()),
                               "port": int((m[:, 1] < m[:, 0]).sum())},
            "inlier_flips_against_float64": {"reference": int(m[:, 2].sum()),
                                             "port": int(m[:, 3].sum())}}


def interactive_run(seed: int, images, ts, gt, flag: str = "None", boxes=None,
                    modes: bool = False, record_init: str = None,
                    port_frames: list = None) -> dict:
    """The interactive protocol on the reference (see the module
    docstring)."""
    import os

    import jax

    from chip_smoke import N_BOXES as BOXES, interactive_modes
    from eao_slam_tpu.config import CapacityConfig, tum3_config
    from eao_slam_tpu.runtime import tracker
    from eao_slam_tpu.system import System
    from port_ate_spread import INIT_DRAWS, InitAttempts, drive_recorded

    objects = flag != "None"
    cap = CapacityConfig(max_keyframes=128, max_points=8192, max_features=1024,
                         local_ba_points=2048,
                         **(dict(max_boxes=BOXES, max_objects=32) if objects else {}))
    sysm = System(tum3_config(flag).replace(capacity=cap, seed=seed), chunked=False)
    per_frame = None
    if objects:
        per_frame = [tuple(np.asarray(b[k]) for b in boxes) for k in range(len(images))]
    if port_frames is not None:
        from eao_slam_tpu.runtime.frame import frame_from_arrays

        k = iter(range(len(port_frames)))

        def port_orb(img, t, boxes=None):
            return sysm.track_frame(frame_from_arrays(sysm.cfg, **port_frames[next(k)]), t)

        sysm.track_monocular = port_orb
    draw = jax.jit(init_draw) if record_init else None
    with InitAttempts(tracker, draw=draw) as attempts:
        out = {"seed": seed, "flag": flag, "interactive": True,
               "front_end": "port" if port_frames is not None else "reference",
               **drive_recorded(sysm, ts, gt, images, per_frame, attempts)}
    if record_init:
        os.makedirs(record_init, exist_ok=True)
        out["init_draws"] = os.path.join(record_init, INIT_DRAWS.format(seed))
        attempts.save(out["init_draws"])
    if modes:
        out["modes"] = interactive_modes(sysm, ts, gt, images)
    return out


def ground_run(seed: int, scene, ts, gt, flag: str) -> dict:
    """chip_smoke.py's ground-alignment run on the reference (see the
    module docstring)."""
    import os
    import tempfile

    import jax.numpy as jnp

    from chip_smoke import TILT_DEG, TILT_FRAMES, _tilt
    from eao_slam_tpu.config import CapacityConfig, tum3_config
    from eao_slam_tpu.geometry.camera import TUM3
    from eao_slam_tpu.io.synthetic import project_boxes, render_image
    from eao_slam_tpu.io.trajectory import save_tum
    from eao_slam_tpu.io.tum import load_groundtruth, lookup_pose_matrix
    from eao_slam_tpu.runtime.frame import frame_from_image
    from eao_slam_tpu.runtime.scan_tracker import ChunkedTracker, batch_from_frames
    from eao_slam_torch.io.trajectory import object_yaws

    Q = _tilt(*TILT_DEG)
    gt_t = np.stack([np.concatenate([T[:3, :3] @ Q.T, T[:3, 3:4]], 1) for T in gt[:TILT_FRAMES]])
    ts = ts[:TILT_FRAMES]
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "groundtruth.txt")
        save_tum(path, ts, gt_t)
        truth = load_groundtruth(path)
    cfg = tum3_config(flag).replace(capacity=CapacityConfig(
        max_keyframes=128, max_points=8192, max_features=1024, local_ba_points=2048,
        max_boxes=N_BOXES, max_objects=32), seed=seed)
    tracker = ChunkedTracker(cfg, chunk=CHUNK)

    def frame(k):
        b = project_boxes(scene, TUM3, gt_t[k], N_BOXES)
        return frame_from_image(cfg, render_image(scene, TUM3, gt_t[k]).astype(np.float32),
                                **dict(zip(("boxes", "box_class", "box_score", "box_valid"), b)))

    i = 0
    while tracker.carry is None:
        tracker.bootstrap(frame(i), float(ts[i]), gt_pose=lookup_pose_matrix(truth, ts[i]))
        i += 1
    slot = tracker.inner.kf_slots[0]
    kf0_t = float(np.asarray(tracker.inner.map.kf_timestamp)[slot])
    kf0 = np.asarray(tracker.inner.map.kf_pose)[slot]
    while i < TILT_FRAMES:
        n = min(CHUNK, TILT_FRAMES - i)
        frames = [frame(k) for k in range(i, i + n)]
        batch = batch_from_frames(frames + [frames[-1]] * (CHUNK - n),
                                  list(ts[i:i + n]) + [ts[i + n - 1]] * (CHUNK - n),
                                  with_boxes=True)
        if n < CHUNK:
            batch = batch._replace(active=jnp.asarray(np.arange(CHUNK) < n))
        tracker.track_batch(batch)
        i += n
    i0 = int(np.argmin(np.abs(ts - kf0_t)))
    tab = {k: np.asarray(v) for k, v in tracker.carry.table._asdict().items()}
    return {"seed": seed, "flag": flag, "ground": True, "init_frame": i0,
            "first_kf_max_abs_diff": float(np.abs(kf0 - gt_t[i0]).max()),
            "tracked": len(tracker.frame_trajectory()[0]), "object_yaws": object_yaws(tab)}


def replay_yaw(path: str) -> dict:
    """The reference's yaw functions on the port's recorded inputs (see the
    module docstring)."""
    import jax.numpy as jnp

    from eao_slam_tpu.geometry.camera import TUM3
    from eao_slam_tpu.objects.state import empty_object_table
    from eao_slam_tpu.objects.yaw import update_yaw, yaw_sample_scores

    z = np.load(path)
    n, J = z["in_valid"].shape
    fields = ("valid", "cls", "center", "cub_min", "cub_max", "yaw", "yaw_hist")
    out = {"file": path, "calls": int(n), "counts_or_lines_differ": 0, "errs_deg": 0.0,
           "yaw_hist": 0.0, "yaw_differs": 0}
    for i in range(n):
        table = empty_object_table(J, z["in_yaw_hist"].shape[2])._replace(
            **{f: jnp.asarray(z["in_" + f][i]) for f in fields})
        targets = jnp.asarray(z["targets"][i].astype(np.int32))
        counts, errs, n_lines = yaw_sample_scores(
            TUM3, table, targets, *(jnp.asarray(z[k][i]) for k in ("boxes", "T_cw", "lines",
                                                                   "line_valid")))
        if not (np.array_equal(np.asarray(counts), z["counts"][i])
                and np.array_equal(np.asarray(n_lines), z["n_lines"][i])):
            out["counts_or_lines_differ"] += 1
        out["errs_deg"] = max(out["errs_deg"], float(np.abs(np.asarray(errs) - z["errs"][i]).max()))
        new = update_yaw(table, targets, counts, errs, n_lines)
        out["yaw_hist"] = max(out["yaw_hist"],
                              float(np.abs(np.asarray(new.yaw_hist) - z["out_yaw_hist"][i]).max()))
        out["yaw_differs"] += int(np.abs(np.asarray(new.yaw) - z["out_yaw"][i]).max() > 1e-6)
    last = {"valid": z["in_valid"][-1], "cls": z["in_cls"][-1]}
    hist = np.asarray(new.yaw_hist)
    out["objects"] = [
        {"slot": int(j), "cls": int(last["cls"][j]),
         "port_yaw_deg": float(np.rad2deg(z["out_yaw"][-1][j])),
         "reference_yaw_deg": float(np.rad2deg(np.asarray(new.yaw)[j])),
         "votes_by_sample": hist[j, :, 0].astype(int).tolist(),
         "mean_score_by_sample": {int(s): float(hist[j, s, 1])
                                  for s in np.flatnonzero(hist[j, :, 0])}}
        for j in np.flatnonzero(last["valid"])]
    return out


def dense_run(scene, images, ts, gt, boxes) -> dict:
    """bench.py's dense protocol through the reference's System (see the
    module docstring)."""
    import os
    import tempfile
    import time

    from eao_slam_tpu.config import CapacityConfig, DemoFlag, tum3_config
    from eao_slam_tpu.evaluation import (
        evaluate_reconstruction, icp_register, load_cloud, mean_cloud_distance,
        random_downsample)
    from eao_slam_tpu.geometry.camera import TUM3
    from eao_slam_tpu.runtime.frame import frame_from_image
    from eao_slam_tpu.system import System
    from eao_slam_torch.io.synthetic import depth_cloud
    from eao_slam_torch.io.trajectory import umeyama_alignment

    cap = CapacityConfig(max_keyframes=128, max_points=8192, max_features=1024,
                         local_ba_points=2048, max_boxes=N_BOXES, max_objects=32)
    cfg = tum3_config(DemoFlag.FULL).replace(capacity=cap)
    sysm = System(cfg, chunk=CHUNK)
    for k in range(DENSE_FRAMES):
        kw = dict(zip(("boxes", "box_class", "box_score", "box_valid"), (b[k] for b in boxes)))
        sysm.track_frame(frame_from_image(cfg, images[k].astype(np.float32), **kw),
                         float(ts[k]), img=images[k])
    sysm.flush()
    t0 = time.perf_counter()
    res = sysm.shutdown(semidense=True)
    dt = time.perf_counter() - t0
    slots = sysm._semidense_slots
    kf_ts = np.asarray(sysm.tracker.map.kf_timestamp)
    kf_valid = np.asarray(sysm.tracker.map.kf_valid)
    first = int(np.flatnonzero(kf_valid)[np.argmin(kf_ts[kf_valid])])
    frame = [int(np.argmin(np.abs(ts - kf_ts[s]))) for s in slots]
    out = {"keyframes": len(slots), "seconds": dt, "s_per_kf": dt / len(slots),
           "semidense_valid": int(np.asarray(res.valid).sum()),
           "segments": int(len(sysm._lines3d)), "triangles": int(len(sysm._mesh_tris))}
    T_ref = gt[int(np.argmin(np.abs(ts - kf_ts[first])))]
    with tempfile.TemporaryDirectory() as d:
        est_path, gt_path = os.path.join(d, "semidense.obj"), os.path.join(d, "truth.xyz")
        out["exported_points"] = sysm.save_semidense_obj(est_path)
        np.savetxt(gt_path, depth_cloud(scene, TUM3, gt[frame], T_ref))
        out["evaluate_reconstruction"] = evaluate_reconstruction(est_path, gt_path)
        est, truth = load_cloud(est_path), load_cloud(gt_path)
    # the same scaled ICP started from the sim3 of the keyframe centres onto
    # their true centres (chip_smoke.cloud_quality)
    true_c = centers(gt[frame]) @ T_ref[:3, :3].T + T_ref[:3, 3]
    init = umeyama_alignment(centers(np.asarray(sysm.tracker.map.kf_pose)[slots]), true_c)
    s_, R_, t_ = icp_register(random_downsample(est, 0.1, seed=1),
                              random_downsample(truth, 0.1, seed=2), init=init)
    from eao_slam_tpu.evaluation import nearest_neighbors

    _, dist = nearest_neighbors((s_ * (R_ @ est.T)).T + t_, truth)
    out["trajectory_init"] = {"scale": float(s_), "mean_distance": mean_cloud_distance(
        est, truth, (s_, R_, t_)), "median_distance": float(np.median(dist)),
        "init_mean_distance": mean_cloud_distance(est, truth, init)}
    return out


def cli_run(images, ts, gt) -> dict:
    """The reference's mono_tum on the arc as a TUM directory (see the
    module docstring)."""
    import tempfile
    import time

    import chip_smoke
    from eao_slam_tpu.cli import run_mono_tum

    with tempfile.TemporaryDirectory() as d:
        seq, out = f"{d}/tum", f"{d}/out"
        chip_smoke.write_tum_sequence(seq, ts, gt, images, chip_smoke.bench_boxes(gt))
        t0 = time.perf_counter()
        stats = run_mono_tum("EAO", seq, out)
        seconds = time.perf_counter() - t0
        fig = chip_smoke.cli_figures(out, stats, ts, gt)
    return {"cli": "mono_tum EAO", **fig, "stats": stats, "seconds": seconds}


def init_rates(root: str, scenes, n_keys: int) -> None:
    """--cli-test --init-rates (see the module docstring)."""
    import os

    import jax
    import jax.numpy as jnp
    import torch

    from eao_slam_torch.config import tum3_config as port_config
    from eao_slam_torch.geometry.camera import TUM3 as PORT_TUM3
    from eao_slam_torch.runtime import tracking_kernels as port_tk
    from eao_slam_torch.runtime.frame import frame_from_image as port_frame
    from eao_slam_torch.solvers import init2view as port_init
    from eao_slam_tpu.config import tum3_config
    from eao_slam_tpu.geometry.camera import TUM3
    from eao_slam_tpu.io.native_loader import SequenceLoader
    from eao_slam_tpu.io.tum import load_image_list
    from eao_slam_tpu.runtime import tracking_kernels as tk
    from eao_slam_tpu.runtime.frame import frame_from_image
    from eao_slam_tpu.solvers import init2view
    from port_ate_spread import write_cli_test_sequence

    draw = jax.jit(init_draw)
    jc, tc = tum3_config("EAO"), port_config("EAO")
    min_tri = jc.tracking.min_init_matches // 2

    def arrays(f):
        return tuple(getattr(f, a) for a in ("kp", "desc", "angle", "valid"))

    for scene in scenes:
        seq = os.path.join(root, f"scene{scene}")
        write_cli_test_sequence(seq, scene)
        lst = load_image_list(os.path.join(seq, "rgb.txt"))
        with SequenceLoader(seq, lst.filenames, lst.timestamps, 640, 480) as loader:
            imgs = [np.asarray(img, np.float32) for _, _, img in loader][:4]
        ref = [frame_from_image(jc, im) for im in imgs]
        port = [port_frame(tc, im, "cpu") for im in imgs]
        for k in (1, 2, 3):
            jidx, _, jok = tk.match_for_init(*arrays(ref[0]), *arrays(ref[k]))
            tidx, _, tok = port_tk.match_for_init(*arrays(port[0]), *arrays(port[k]))
            tok_np = tok.numpy()
            ok = [0, 0]
            for s in range(n_keys):
                key = jax.random.PRNGKey(5000 + s)
                ok[0] += bool(init2view.initialize_two_view(
                    TUM3, ref[0].kp, ref[k].kp[jidx], jok, key, min_triangulated=min_tri).success)
                hyp = torch.as_tensor(np.asarray(draw(jnp.asarray(tok_np), key)))
                ok[1] += bool(port_init.initialize_two_view(
                    PORT_TUM3, port[0].kp, port[k].kp[tidx.long()], tok, hyp_idx=hyp,
                    min_triangulated=min_tri).success)
            print(json.dumps({"scene": scene, "frame": k, "matches": [int(np.sum(jok)),
                              int(tok_np.sum())], "successes": ok, "of": n_keys}), flush=True)


def cli_test(args) -> None:
    """--cli-test: the reference's run_mono_tum per scene and RANSAC seed."""
    import os

    import jax

    from eao_slam_tpu import cli
    from eao_slam_tpu.runtime import tracker
    from port_ate_spread import CLI_INIT_DRAWS, cli_test_run, write_cli_test_sequence

    if args.init_rates:
        init_rates(args.cli_test, args.scenes, args.init_rates)
        return
    draw = jax.jit(init_draw) if args.record_init else None
    for scene in args.scenes:
        seq = os.path.join(args.cli_test, f"scene{scene}")
        ts, gt = write_cli_test_sequence(seq, scene)
        for seed in args.seeds:
            r, attempts = cli_test_run(cli, tracker, seq, ts, gt, seed, draw=draw)
            if args.record_init:
                os.makedirs(args.record_init, exist_ok=True)
                r["init_draws"] = os.path.join(args.record_init,
                                               CLI_INIT_DRAWS.format(scene, seed))
                attempts.save(r["init_draws"])
            print(json.dumps({"package": "reference", "scene": scene, **r}), flush=True)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seeds", type=int, nargs="+", default=[12345, 1, 2, 3, 4, 5, 6])
    p.add_argument("--flag", default="None",
                   help="DemoFlag value: None (geometry) or a flag of the object layer")
    p.add_argument("--ground", action="store_true",
                   help="chip_smoke.py's tilted ground-alignment run instead of the arc")
    p.add_argument("--replay-yaw", nargs="+", metavar="FILE",
                   help="the reference's yaw functions on yaw calls recorded from the port")
    p.add_argument("--dense", action="store_true",
                   help="bench.py's dense protocol in FULL mode, with the cloud's quality")
    p.add_argument("--interactive", action="store_true",
                   help="the interactive per-frame tracker, System(chunked=False)")
    p.add_argument("--port-orb", action="store_true",
                   help="with --interactive: the reference's tracker on the port's ORB features")
    p.add_argument("--lockstep", action="store_true",
                   help="with --interactive: the port one step from the reference's state")
    p.add_argument("--stage-audit", action="store_true",
                   help="with --interactive: the reference's triangulations and motion-model "
                        "pose LMs through the port on the same inputs")
    p.add_argument("--frames", type=int, default=100,
                   help="--lockstep, --stage-audit: frames to run")
    p.add_argument("--cli", action="store_true",
                   help="the reference's mono_tum driver on the arc as a TUM directory")
    p.add_argument("--cli-test", metavar="DIR",
                   help="run_mono_tum on tests/test_cli.py's sequence, read from or written "
                        "under DIR")
    p.add_argument("--scenes", type=int, nargs="+", default=[4],
                   help="--cli-test: the scene seeds")
    p.add_argument("--init-rates", type=int, metavar="N",
                   help="--cli-test: N init draws per attempt in each package, no run_mono_tum")
    p.add_argument("--record-init", metavar="DIR",
                   help="with --interactive or --cli-test: write each run's init draws to DIR")
    p.add_argument("--eager", action="store_true",
                   help="with --interactive: every seed inside jax.disable_jit()")
    p.add_argument("--modes", action="store_true",
                   help="with --interactive: kidnap, localization mode and reset after the pass")
    args = p.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    if args.replay_yaw:
        for path in args.replay_yaw:
            print(json.dumps(replay_yaw(path)), flush=True)
        return
    if args.cli_test:
        cli_test(args)
        return
    from eao_slam_tpu.geometry.camera import TUM3
    from eao_slam_tpu.io.synthetic import (
        make_arc_trajectory, make_room_scene, project_boxes, render_image)

    scene = make_room_scene(seed=5, n_landmarks=200, n_objects=3, obj_z_range=(4.0, 5.2))
    ts, gt = make_arc_trajectory(n_frames=N_FRAMES, sweep_deg=60.0)
    if args.ground:
        for seed in args.seeds:
            print(json.dumps(ground_run(seed, scene, ts, gt, args.flag)), flush=True)
        return
    if args.dense:
        images = np.stack([render_image(scene, TUM3, T) for T in gt[:DENSE_FRAMES]])
        boxes = [np.stack([np.asarray(project_boxes(scene, TUM3, T, N_BOXES)[k])
                           for T in gt[:DENSE_FRAMES]]) for k in range(4)]
        print(json.dumps(dense_run(scene, images, ts, gt, boxes)), flush=True)
        return
    images = np.stack([render_image(scene, TUM3, T) for T in gt])
    if args.cli:
        print(json.dumps(cli_run(images, ts, gt)), flush=True)
        return
    boxes = None
    if args.flag != "None":
        per_frame = [project_boxes(scene, TUM3, T, N_BOXES) for T in gt]
        boxes = tuple(np.stack([np.asarray(b[k]) for b in per_frame]) for k in range(4))
    if args.lockstep:
        for seed in args.seeds:
            print(json.dumps(lockstep_run(seed, images, ts, args.frames)), flush=True)
        return
    if args.stage_audit:
        for seed in args.seeds:
            print(json.dumps(stage_audit(seed, images, ts, args.frames)), flush=True)
        return
    port_frames = port_orb_frames(images) if args.port_orb else None
    runs = []
    for seed in args.seeds:
        if args.interactive:
            with jax.disable_jit(args.eager):
                r = interactive_run(seed, images, ts, gt, args.flag, boxes, args.modes,
                                    args.record_init, port_frames)
            r["eager"] = args.eager
        else:
            r = run(seed, images, ts, gt, args.flag, boxes, scene)
        runs.append(r)
        print(json.dumps(r), flush=True)
    ates = [r["ate_m"] for r in runs]
    summary = {"flag": args.flag, "median_ate_m": float(np.median(ates)),
               "max_ate_m": float(np.max(ates)), "seeds": args.seeds,
               "min_tracked_share": min(r["tracked"] / r["total"] for r in runs)}
    if boxes is not None:
        summary["min_objects"] = min(r["objects"] for r in runs)
        summary["max_object_centre_err_m"] = max(max(r["object_centre_err_m"]) for r in runs)
        summary["max_supported_yaw_err_deg"] = max(
            [abs(o["yaw_deg"]) for r in runs for o in r.get("object_yaws", [])
             if o["votes"] >= 3], default=None)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
