"""Spread of the JAX reference's bench-arc ATE over RANSAC seeds, on the CPU.

    JAX_PLATFORMS=cpu python reference_ate_spread.py [--flag EAO] [--seeds 12345 1 2 3 4 5 6]
    JAX_PLATFORMS=cpu python reference_ate_spread.py --flag LineAndiForest --seeds ...
    JAX_PLATFORMS=cpu python reference_ate_spread.py --flag LineAndiForest --ground --seeds ...
    JAX_PLATFORMS=cpu python reference_ate_spread.py --replay-yaw DIR/yaw_calls_seed5.npz ...
    JAX_PLATFORMS=cpu python reference_ate_spread.py --dense
    JAX_PLATFORMS=cpu python reference_ate_spread.py --interactive [--flag EAO] [--modes] \
        --seeds ...

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
are axis-aligned in the first camera's frame, so the true yaw is 0. In
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
frames 60-91 and a reset. About 10 minutes a seed on one core.

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
    return out


def interactive_run(seed: int, images, ts, gt, flag: str = "None", boxes=None,
                    modes: bool = False) -> dict:
    """The interactive protocol on the reference (see the module
    docstring)."""
    from chip_smoke import N_BOXES as BOXES, drive_interactive, interactive_modes
    from eao_slam_tpu.config import CapacityConfig, tum3_config
    from eao_slam_tpu.system import System

    objects = flag != "None"
    cap = CapacityConfig(max_keyframes=128, max_points=8192, max_features=1024,
                         local_ba_points=2048,
                         **(dict(max_boxes=BOXES, max_objects=32) if objects else {}))
    sysm = System(tum3_config(flag).replace(capacity=cap, seed=seed), chunked=False)
    per_frame = None
    if objects:
        per_frame = [tuple(np.asarray(b[k]) for b in boxes) for k in range(len(images))]
    out = {"seed": seed, "flag": flag, "interactive": True,
           **drive_interactive(sysm, ts, gt, images, per_frame)}
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
    p.add_argument("--modes", action="store_true",
                   help="with --interactive: kidnap, localization mode and reset after the pass")
    args = p.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    if args.replay_yaw:
        for path in args.replay_yaw:
            print(json.dumps(replay_yaw(path)), flush=True)
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
    boxes = None
    if args.flag != "None":
        per_frame = [project_boxes(scene, TUM3, T, N_BOXES) for T in gt]
        boxes = tuple(np.stack([np.asarray(b[k]) for b in per_frame]) for k in range(4))
    runs = []
    for seed in args.seeds:
        if args.interactive:
            r = interactive_run(seed, images, ts, gt, args.flag, boxes, args.modes)
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
