"""Shared fixtures for the parity tests of the port's object layer against
the reference package's (``eao_slam_tpu/objects``), on the CPU.

``object_replay`` drives the reference's object stages frame by frame
along a feature-level sequence with ground-truth poses and known
feature-to-point bindings (the room of seed 3, 40 frames of a 35-degree
arc, 256 features, 8 boxes, 16 object slots), with the chunk-rate iForest
cull every 8 frames and the merge pass after it, as the chunked tracker
paces them; it records every stage's inputs and outputs as numpy, so a
test can hand the port the reference's state at any frame.
``reference_iforest_draws`` gives the draws the reference's iForest makes
from a key, for the port to take as injected draws.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from torch_parity import n, t

CAP = dict(max_keyframes=64, max_points=4096, max_features=256, max_boxes=8, max_objects=16,
           local_ba_points=1024)
N_FRAMES = 40
CHUNK = 8
IFOREST_SEED = 12345


def reference_iforest_draws(key, mask, psi: int, depth: int, n_trees: int = 50):
    """The reference's iForest draws for the rows of ``mask`` [R, S] from
    ``key``: one key per row (``jax.random.split(key, R)``), split three
    ways into the weighted subsample choice, the split dimensions and the
    split fractions, as ``anomaly_scores`` draws them. Returns the port's
    ``IForestDraws`` (CPU tensors)."""
    import jax
    import jax.numpy as jnp
    import torch

    from eao_slam_torch.objects.iforest import IForestDraws

    mask = n(mask)
    R, S = mask.shape
    nodes = 1 << depth
    sub, dims, fracs = [], [], []
    for k, msk in zip(jax.random.split(key, R), mask):
        k_sub, k_dims, k_fracs = jax.random.split(k, 3)
        p = jnp.asarray(msk, jnp.float32)
        p = p / jnp.maximum(jnp.sum(p), 1.0)
        sub.append(np.asarray(jax.random.choice(k_sub, S, shape=(n_trees, psi), p=p)))
        dims.append(np.asarray(jax.random.randint(k_dims, (depth, n_trees, nodes), 0, 3)))
        fracs.append(np.asarray(jax.random.uniform(k_fracs, (depth, n_trees, nodes))))
    return IForestDraws(torch.as_tensor(np.stack(sub)).long(),
                        torch.as_tensor(np.stack(dims)).long(),
                        torch.as_tensor(np.stack(fracs)))


def draws_from(key, psi: int, depth: int):
    """A ``draw(mask)`` callable giving the reference's draws from ``key``."""
    return lambda mask: reference_iforest_draws(key, mask, psi, depth)


def jax_object_config(flag: str = "EAO"):
    from eao_slam_tpu.config import CapacityConfig, TrackingConfig, tum3_config

    return tum3_config(flag).replace(tracking=TrackingConfig(enable_loop_closing=False),
                                     capacity=CapacityConfig(**CAP))


def torch_object_config(flag: str = "EAO"):
    from eao_slam_torch.config import CapacityConfig, TrackingConfig, tum3_config

    return tum3_config(flag).replace(tracking=TrackingConfig(enable_loop_closing=False),
                                     capacity=CapacityConfig(**CAP))


def table_numpy(table) -> dict:
    return {f: n(getattr(table, f)) for f in table._fields}


def torch_table(d: dict):
    from eao_slam_torch.convert import object_table_from_numpy

    return object_table_from_numpy(d, "cpu")


def jax_table(d: dict):
    import jax.numpy as jnp

    from eao_slam_tpu.objects.state import ObjectTable

    return ObjectTable(**{k: jnp.asarray(v) for k, v in d.items()})


@lru_cache(maxsize=None)
def object_sequence():
    """The scene, its landmarks as the map points (P = 4096 slots, the
    first M valid, positions with 1 cm noise), and per frame the ground
    truth pose, the simulated features bound to their landmarks (cur_pt)
    and the projected boxes. Every 5th frame from frame 12 on drops the
    first box, so the motion-IoU stage misses and the later stages decide."""
    from eao_slam_torch.geometry.camera import TUM3
    from eao_slam_torch.io.synthetic import (
        make_arc_trajectory, make_room_scene, project_boxes, simulate_observations)

    scene = make_room_scene(seed=3, n_landmarks=1200, n_objects=3)
    ts, gt = make_arc_trajectory(n_frames=N_FRAMES, sweep_deg=35.0)
    rng = np.random.default_rng(7)
    P = CAP["max_points"]
    M = len(scene.landmarks)
    pt_pos = np.zeros((P, 3), np.float32)
    pt_pos[:M] = scene.landmarks + rng.normal(0, 0.01, (M, 3))
    pt_valid = np.zeros(P, bool)
    pt_valid[:M] = True
    frames = []
    for k, T in enumerate(gt):
        o = simulate_observations(scene, TUM3, T, max_features=CAP["max_features"], rng=rng,
                                  pixel_noise=0.4, bit_flips=6, dropout=0.05)
        bxs, cls, score, bvalid = project_boxes(scene, TUM3, T, CAP["max_boxes"])
        if k >= 12 and k % 5 == 0:
            bvalid = bvalid.copy()
            bvalid[0] = False
        frames.append(dict(T=T.astype(np.float32), kp=o["kp"], cur_pt=o["lm_idx"],
                           boxes=bxs, cls=cls, score=score, bvalid=bvalid))
    return scene, pt_pos, pt_valid, frames


@lru_cache(maxsize=None)
def object_replay():
    """The reference's object stages along ``object_sequence``: per frame a
    dict with the inputs (map membership and table before the frame), the
    detection statistics, the cascade's result, and the membership and
    table after the frame's update; every CHUNK frames the chunk-rate cull
    (its key recorded) and the merge pass, with their inputs and outputs."""
    import jax
    import jax.numpy as jnp

    from eao_slam_tpu.geometry.camera import TUM3
    from eao_slam_tpu.objects import stats
    from eao_slam_tpu.objects.association import (
        N_OBJ_SAMPLE, apply_frame_update, chunk_iforest_cull, compute_detection_stats)
    from eao_slam_tpu.objects.iforest import psi_depth_for
    from eao_slam_tpu.objects.merge import run_merge_pass
    from eao_slam_tpu.objects.resolve import resolve_cascade
    from eao_slam_tpu.objects.state import empty_object_table
    from eao_slam_tpu.runtime.map_state import MapState

    cfg = jax_object_config()
    scene, pt_pos, pt_valid, frames = object_sequence()
    P = pt_pos.shape[0]
    psi, depth = psi_depth_for(N_OBJ_SAMPLE)
    t_table = jnp.asarray(stats.make_t_table())
    table = empty_object_table(CAP["max_objects"])
    m = MapState(**{f: None for f in MapState._fields})._replace(
        pt_pos=jnp.asarray(pt_pos), pt_valid=jnp.asarray(pt_valid),
        pt_object_id=jnp.full((P,), -1, jnp.int32), pt_obj_votes=jnp.zeros((P,), jnp.int32))
    key = jax.random.PRNGKey(IFOREST_SEED)
    out = {"frames": [], "culls": [], "merges": []}
    for k, f in enumerate(frames):
        frame_id = k + 1
        rec = {"frame_id": frame_id, "pt_object_id": n(m.pt_object_id),
               "pt_obj_votes": n(m.pt_obj_votes), "table": table_numpy(table)}
        T = jnp.asarray(f["T"][:3])
        det = compute_detection_stats(
            TUM3, m.pt_pos, m.pt_valid, m.pt_object_id, table, T, jnp.asarray(f["kp"]),
            jnp.asarray(f["cur_pt"]), jnp.asarray(f["boxes"]), jnp.asarray(f["cls"]),
            jnp.asarray(f["score"]), jnp.asarray(f["bvalid"]), jnp.int32(frame_id))
        res = resolve_cascade(det, table, t_table, jnp.asarray(f["boxes"]),
                              cfg.objects.proj_iou_threshold, img_w=640, img_h=480,
                              min_points=cfg.objects.min_points_per_object)
        key, k_frame = jax.random.split(key)
        m, table = apply_frame_update(
            TUM3, m, table, det, res.assoc, res.new_slots, jnp.asarray(f["boxes"]),
            jnp.asarray(f["cls"]), T, jnp.asarray(f["kp"]), jnp.asarray(f["cur_pt"]),
            jnp.int32(frame_id), k_frame, psi=psi, depth=depth, run_iforest=False)
        table = table._replace(re_obj=table.re_obj + res.re_inc)
        rec.update(det={k2: n(v) for k2, v in det._asdict().items()},
                   res={k2: n(v) for k2, v in res._asdict().items()},
                   frame_key=n(k_frame), pt_object_id_after=n(m.pt_object_id),
                   pt_obj_votes_after=n(m.pt_obj_votes), table_after=table_numpy(table))
        out["frames"].append(rec)
        if frame_id % CHUNK == 0:
            key, k_cull = jax.random.split(key)
            before = {"pt_object_id": n(m.pt_object_id), "pt_obj_votes": n(m.pt_obj_votes),
                      "table": table_numpy(table), "key": n(k_cull), "T": f["T"][:3],
                      "since": frame_id - CHUNK + 1}
            m, table = chunk_iforest_cull(TUM3, m, table, T, jnp.int32(before["since"]),
                                          k_cull, psi=psi, depth=depth)
            before.update(pt_object_id_after=n(m.pt_object_id),
                          pt_obj_votes_after=n(m.pt_obj_votes), table_after=table_numpy(table))
            out["culls"].append(before)
            merge = {"pt_object_id": n(m.pt_object_id), "pt_obj_votes": n(m.pt_obj_votes),
                     "table": table_numpy(table)}
            m, table = run_merge_pass(m, table)
            merge.update(pt_object_id_after=n(m.pt_object_id),
                         pt_obj_votes_after=n(m.pt_obj_votes), table_after=table_numpy(table))
            out["merges"].append(merge)
    return out


def torch_map(pt_object_id, pt_obj_votes):
    """A port MapState holding the replay's points with the given
    membership (the object stages read only the point fields)."""
    from eao_slam_torch.config import CapacityConfig
    from eao_slam_torch.runtime.map_state import empty_map_state

    _, pt_pos, pt_valid, _ = object_sequence()
    m = empty_map_state(CapacityConfig(max_keyframes=1, max_points=pt_pos.shape[0],
                                       max_features=1), "cpu")
    return m._replace(pt_pos=t(pt_pos), pt_valid=t(pt_valid),
                      pt_object_id=t(pt_object_id).int(), pt_obj_votes=t(pt_obj_votes).int())


def jax_map(pt_object_id, pt_obj_votes):
    import jax.numpy as jnp

    from eao_slam_tpu.runtime.map_state import MapState

    _, pt_pos, pt_valid, _ = object_sequence()
    return MapState(**{f: None for f in MapState._fields})._replace(
        pt_pos=jnp.asarray(pt_pos), pt_valid=jnp.asarray(pt_valid),
        pt_object_id=jnp.asarray(pt_object_id), pt_obj_votes=jnp.asarray(pt_obj_votes))
