"""Spread of the JAX reference's bench-arc ATE over RANSAC seeds, on the CPU.

    JAX_PLATFORMS=cpu python reference_ate_spread.py [--flag EAO] [--seeds 12345 1 2 3 4 5 6]

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
``sim3_object_errors``), then the median and the worst.

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
    from eao_slam_tpu.runtime.scan_tracker import ChunkedTracker, make_extract_track
    from eao_slam_torch.io.trajectory import map_object_errors, sim3_object_errors

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

    i = 0
    while tracker.carry is None:
        kw = {k: v[0] for k, v in box_kw(i, i + 1).items()}
        tracker.bootstrap(frame_from_image(cfg, images[i].astype(np.float32), **kw),
                          float(ts[i]))
        i += 1
    n_boot = i
    n_warm = warmup_frames(n_boot)
    assert n_warm > 0, f"bootstrap took {n_boot} frames"
    tracker.track_images(images[i:i + n_warm], ts[i:i + n_warm], **box_kw(i, i + n_warm))
    carry = tracker.carry
    i += n_warm
    poses, states = [], []
    for _ in range(N_TIMED):
        if objects:
            outs = tracker.track_images(images[i:i + CHUNK], ts[i:i + CHUNK],
                                        **box_kw(i, i + CHUNK))
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
    return out


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seeds", type=int, nargs="+", default=[12345, 1, 2, 3, 4, 5, 6])
    p.add_argument("--flag", default="None",
                   help="DemoFlag value: None (geometry) or a flag of the object layer")
    args = p.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    from eao_slam_tpu.geometry.camera import TUM3
    from eao_slam_tpu.io.synthetic import (
        make_arc_trajectory, make_room_scene, project_boxes, render_image)

    scene = make_room_scene(seed=5, n_landmarks=200, n_objects=3, obj_z_range=(4.0, 5.2))
    ts, gt = make_arc_trajectory(n_frames=N_FRAMES, sweep_deg=60.0)
    images = np.stack([render_image(scene, TUM3, T) for T in gt])
    boxes = None
    if args.flag != "None":
        per_frame = [project_boxes(scene, TUM3, T, N_BOXES) for T in gt]
        boxes = tuple(np.stack([np.asarray(b[k]) for b in per_frame]) for k in range(4))
    runs = []
    for seed in args.seeds:
        r = run(seed, images, ts, gt, args.flag, boxes, scene)
        runs.append(r)
        print(json.dumps(r), flush=True)
    ates = [r["ate_m"] for r in runs]
    summary = {"flag": args.flag, "median_ate_m": float(np.median(ates)),
               "max_ate_m": float(np.max(ates)), "seeds": args.seeds}
    if boxes is not None:
        summary["min_objects"] = min(r["objects"] for r in runs)
        summary["max_object_centre_err_m"] = max(max(r["object_centre_err_m"]) for r in runs)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
