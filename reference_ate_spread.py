"""Spread of the JAX reference's bench-arc ATE over RANSAC seeds, on the CPU.

    JAX_PLATFORMS=cpu python reference_ate_spread.py [--seeds 12345 1 2 3 4 5 6]

Runs the reference package (eao_slam_tpu) as bench.py's headline mode
does, at bench.py's capacities on its rendered 60-degree arc of 168
frames: bootstrap, a warm-up chunk, four timed chunks of 32 frames. Loop
closing is off, as in the port. Only ``SystemConfig.seed`` changes between
runs; it seeds the two-view initializer's RANSAC draws. A seed whose
bootstrap takes more than 8 frames gets a shorter (padded) warm-up chunk,
so that the timed chunks still fit the arc; for the others this is
bench.py's protocol exactly (chip_smoke.py follows the same rule). For
each seed it prints one JSON line with the frames tracked and the sim3 ATE
of the timed trajectory, then the median and the worst.

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


def warmup_frames(n_boot: int) -> int:
    """One chunk after the bootstrap, cut so the timed chunks fit the arc."""
    return min(CHUNK, N_FRAMES - N_TIMED * CHUNK - n_boot)


def run(seed: int, images, ts, gt) -> dict:
    import jax.numpy as jnp

    from eao_slam_tpu.config import CapacityConfig, TrackingConfig, tum3_config
    from eao_slam_tpu.io.trajectory import ate_rmse
    from eao_slam_tpu.runtime.frame import frame_from_image
    from eao_slam_tpu.runtime.scan_tracker import ChunkedTracker, make_extract_track

    cap = CapacityConfig(max_keyframes=128, max_points=8192, max_features=1024,
                         local_ba_points=2048)
    cfg = tum3_config().replace(capacity=cap, seed=seed,
                                tracking=TrackingConfig(enable_loop_closing=False))
    tracker = ChunkedTracker(cfg, chunk=CHUNK)
    extract_track = make_extract_track(cfg, tracker._track_chunk)
    i = 0
    while tracker.carry is None:
        tracker.bootstrap(frame_from_image(cfg, images[i].astype(np.float32)), float(ts[i]))
        i += 1
    n_boot = i
    n_warm = warmup_frames(n_boot)
    assert n_warm > 0, f"bootstrap took {n_boot} frames"
    tracker.track_images(images[i:i + n_warm], ts[i:i + n_warm])
    carry = tracker.carry
    i += n_warm
    poses, states = [], []
    for _ in range(N_TIMED):
        carry, outs = extract_track(carry, jnp.asarray(images[i:i + CHUNK]),
                                    jnp.asarray(ts[i:i + CHUNK], jnp.float32))
        poses.append(np.asarray(outs.T))
        states.append(np.asarray(outs.state))
        i += CHUNK
    T = np.concatenate(poses)
    ok = np.concatenate(states) == 2
    g = gt[i - N_TIMED * CHUNK:i]

    def centers(x):
        return np.einsum("nij,ni->nj", -x[:, :3, :3], x[:, :3, 3])

    ate = ate_rmse(centers(T[ok]), centers(g[ok]), with_scale=True)
    return {"seed": seed, "bootstrap_frames": n_boot, "tracked": int(ok.sum()),
            "total": int(ok.size), "ate_m": float(ate)}


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seeds", type=int, nargs="+", default=[12345, 1, 2, 3, 4, 5, 6])
    args = p.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    from eao_slam_tpu.geometry.camera import TUM3
    from eao_slam_tpu.io.synthetic import make_arc_trajectory, make_room_scene, render_image

    scene = make_room_scene(seed=5, n_landmarks=200, n_objects=3, obj_z_range=(4.0, 5.2))
    ts, gt = make_arc_trajectory(n_frames=N_FRAMES, sweep_deg=60.0)
    images = np.stack([render_image(scene, TUM3, T) for T in gt])
    ates = []
    for seed in args.seeds:
        r = run(seed, images, ts, gt)
        ates.append(r["ate_m"])
        print(json.dumps(r), flush=True)
    print(json.dumps({"median_ate_m": float(np.median(ates)), "max_ate_m": float(np.max(ates)),
                      "seeds": args.seeds}))


if __name__ == "__main__":
    main()
