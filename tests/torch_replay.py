"""Replay the reference's chunks through the port at bench width.

    JAX_PLATFORMS=cpu python tests/torch_replay.py dump build/replay.pkl
    python tests/torch_replay.py replay build/replay.pkl [--device cuda]
    JAX_PLATFORMS=cpu python tests/torch_replay.py cosim [--frames 14]

``dump`` (reference, CPU) bootstraps the reference on bench.py's arc at
bench.py's capacities (loop closing off) and runs 5 chunks of 32 frames;
it saves the bootstrap carry and, per chunk, the front-end batch, the
outputs and the carry after it, as numpy.

``replay`` (port only, no JAX import, any device) starts each chunk from
the reference's carry before it, feeds the reference's batch through the
port's ``make_track_chunk`` and prints how far the port's poses, keyframe
flags and allocator counters land from the reference's.

``cosim`` (both, CPU) runs the two per-frame steps side by side from the
reference's bootstrap: the reference chained on its own carry, the port
chained on its own, and at each frame the reference's step once more from
the port's carry. It shows where the two runs part and whether the
reference, given the port's state, does what the port does.
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

CHUNK = 32
N_CHUNKS = 5
CAPACITY = dict(max_keyframes=128, max_points=8192, max_features=1024, local_ba_points=2048)


def _arc():
    from eao_slam_torch.geometry.camera import TUM3
    from eao_slam_torch.io.synthetic import make_arc_trajectory, make_room_scene, render_image

    scene = make_room_scene(seed=5, n_landmarks=200, n_objects=3, obj_z_range=(4.0, 5.2))
    ts, gt = make_arc_trajectory(n_frames=8 + CHUNK * N_CHUNKS, sweep_deg=60.0)
    return ts, gt, scene, TUM3, render_image


def _reference_bootstrap():
    from eao_slam_tpu.config import CapacityConfig, TrackingConfig, tum3_config
    from eao_slam_tpu.runtime.frame import frame_from_image
    from eao_slam_tpu.runtime.scan_tracker import ChunkedTracker

    ts, gt, scene, cam, render = _arc()
    images = np.stack([render(scene, cam, T) for T in gt])
    cfg = tum3_config().replace(capacity=CapacityConfig(**CAPACITY),
                                tracking=TrackingConfig(enable_loop_closing=False))
    tr = ChunkedTracker(cfg, chunk=CHUNK)
    i = 0
    while tr.carry is None:
        tr.bootstrap(frame_from_image(cfg, images[i].astype(np.float32)), float(ts[i]))
        i += 1
    return cfg, tr, images, ts, i


def dump(path: str) -> None:
    from eao_slam_tpu.runtime.frame import frame_from_image
    from eao_slam_tpu.runtime.scan_tracker import batch_from_frames
    from torch_parity import jax_carry_numpy

    cfg, tr, images, ts, i = _reference_bootstrap()
    out = {"carry0": jax_carry_numpy(tr.carry), "chunks": []}
    for _ in range(N_CHUNKS):
        frames = [frame_from_image(cfg, images[j].astype(np.float32)) for j in range(i, i + CHUNK)]
        b = batch_from_frames(frames, ts[i:i + CHUNK])
        carry, o = tr._track_chunk(tr.carry, b)
        tr.carry = carry
        out["chunks"].append({
            "lo": i,
            "batch": {f: np.asarray(getattr(b, f))
                      for f in ("kp", "desc", "octave", "angle", "valid", "timestamp")},
            "T": np.asarray(o.T), "is_kf": np.asarray(o.is_kf),
            "n_inliers": np.asarray(o.n_inliers), "carry": jax_carry_numpy(carry)})
        i += CHUNK
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(out, f)
    print(f"wrote {path}: bootstrap carry and {N_CHUNKS} chunks")


def replay(path: str, device: str) -> None:
    import torch

    from eao_slam_torch.config import CapacityConfig, TrackingConfig, tum3_config
    from eao_slam_torch.convert import carry_from_numpy
    from eao_slam_torch.runtime.scan_tracker import FrameBatch, make_track_chunk

    with open(path, "rb") as f:
        D = pickle.load(f)
    cfg = tum3_config().replace(capacity=CapacityConfig(**CAPACITY),
                                tracking=TrackingConfig(enable_loop_closing=False))
    track = make_track_chunk(cfg)
    prev = D["carry0"]
    for k, ch in enumerate(D["chunks"]):
        b = ch["batch"]
        batch = FrameBatch(**{f: torch.as_tensor(b[f].view(np.int32) if f == "desc" else b[f],
                                                 device=device) for f in b})
        t0 = time.perf_counter()
        _, o = track(carry_from_numpy(prev, device), batch)
        dt = time.perf_counter() - t0
        dT = np.abs(o.T - ch["T"]).reshape(len(o.T), -1).max(1)
        print(f"chunk {k}: max |T - T_ref| {dT.max():.3e}, keyframe flags equal "
              f"{bool((o.is_kf == ch['is_kf']).all())}, keyframes {int(o.kf_count[-1])} vs "
              f"{int(ch['carry']['kf_count'])}, points {int(o.pt_count[-1])} vs "
              f"{int(ch['carry']['pt_count'])}, {dt:.1f} s on {device}", flush=True)
        prev = ch["carry"]


def cosim(n_frames: int) -> None:
    import jax
    import jax.numpy as jnp
    import torch

    from eao_slam_tpu.runtime.frame import frame_from_image
    from eao_slam_tpu.runtime.map_state import MapState as JMap
    from eao_slam_tpu.runtime.scan_tracker import make_chunk_step as reference_step
    from eao_slam_torch.config import CapacityConfig, TrackingConfig, tum3_config
    from eao_slam_torch.convert import carry_from_numpy, carry_to_numpy
    from eao_slam_torch.runtime.frame import Frame
    from eao_slam_torch.runtime.scan_tracker import make_chunk_step
    from torch_parity import jax_carry_numpy

    jcfg, tr, images, ts, i = _reference_bootstrap()
    tcfg = tum3_config().replace(capacity=CapacityConfig(**CAPACITY),
                                 tracking=TrackingConfig(enable_loop_closing=False))
    step_j = jax.jit(reference_step(jcfg))
    step_t = make_chunk_step(tcfg)
    cj = tr.carry
    ct = carry_from_numpy(jax_carry_numpy(cj), "cpu")
    for _ in range(n_frames):
        f = frame_from_image(jcfg, images[i].astype(np.float32))
        xs = (f.kp, f.desc, f.octave, f.angle, f.valid, jnp.float32(ts[i]), jnp.bool_(True))
        ft = Frame(*(torch.as_tensor(np.array(x).view(np.int32) if x is f.desc else np.array(x))
                     for x in (f.kp, f.desc, f.octave, f.angle, f.valid)))
        cj_next, oj = step_j(cj, xs)
        pn = carry_to_numpy(ct)
        cj_from_port = cj._replace(m=JMap(**{k: jnp.asarray(v) for k, v in pn["m"].items()}),
                                   **{k: jnp.asarray(v) for k, v in pn.items() if k != "m"})
        _, oc = step_j(cj_from_port, xs)
        ct, ot = step_t(ct, ft, float(np.float32(ts[i])))
        dT = float(np.abs(np.asarray(oj[0]) - ot[0].cpu().numpy()).max())
        print(f"frame {i}: inliers reference {int(oj[2])}, port {ot[2]}, reference from the "
              f"port's state {int(oc[2])}; points {int(oj[5])}, {ot[5]}, {int(oc[5])}; "
              f"keyframe {bool(oj[3])}, {ot[3]}, {bool(oc[3])}; max |T - T_ref| {dT:.1e}",
              flush=True)
        cj = cj_next
        i += 1


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("mode", choices=("dump", "replay", "cosim"))
    p.add_argument("path", nargs="?", default="build/replay.pkl")
    p.add_argument("--device", default="cpu")
    p.add_argument("--frames", type=int, default=14)
    a = p.parse_args()
    if a.mode in ("dump", "cosim"):
        import jax

        jax.config.update("jax_platforms", "cpu")
    if a.mode == "dump":
        dump(a.path)
    elif a.mode == "replay":
        replay(a.path, a.device)
    else:
        cosim(a.frames)


if __name__ == "__main__":
    main()
