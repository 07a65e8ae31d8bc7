"""Shared fixtures for the parity tests of the PyTorch port against the
JAX package: the same numpy inputs go through both, on the CPU."""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

CPU = torch.device("cpu")

# The tests run in several worker processes at once (pytest-xdist), each of
# which imports this module: one intra-op thread each, or torch's thread
# pools oversubscribe the cores and spin against one another.
torch.set_num_threads(1)


def t(x, dtype=None) -> torch.Tensor:
    """numpy / jax array -> CPU tensor (uint32 descriptors keep their bits
    as int32)."""
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    out = torch.as_tensor(np.array(a))
    return out if dtype is None else out.to(dtype)


def n(x) -> np.ndarray:
    """tensor / jax array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def desc_bits_differ(a, b) -> int:
    """Number of differing bits between two [N, 8] 32-bit descriptor sets."""
    x = np.bitwise_xor(np.asarray(a).view(np.uint32), np.asarray(b).view(np.uint32))
    return int(np.unpackbits(x.view(np.uint8)).sum())


@lru_cache(maxsize=None)
def rendered_arc(n_frames: int = 36, sweep_deg: float = 45.0):
    """The bench scene on a short arc, rendered once per process with the
    port's renderer (tested byte-identical to the reference's)."""
    from eao_slam_torch.geometry.camera import TUM3
    from eao_slam_torch.io.synthetic import make_arc_trajectory, make_room_scene, render_image

    scene = make_room_scene(seed=5, n_landmarks=200, n_objects=3, obj_z_range=(4.0, 5.2))
    ts, gt = make_arc_trajectory(n_frames=n_frames, sweep_deg=sweep_deg)
    images = np.stack([render_image(scene, TUM3, T) for T in gt])
    return ts, gt, images


def small_capacity_kw():
    return dict(max_keyframes=64, max_points=4096, max_features=256, local_ba_points=1024)


def jax_config():
    from eao_slam_tpu.config import CapacityConfig, TrackingConfig, tum3_config

    return tum3_config().replace(tracking=TrackingConfig(enable_loop_closing=False),
                                 capacity=CapacityConfig(**small_capacity_kw()))


def torch_config():
    from eao_slam_torch.config import CapacityConfig, TrackingConfig, tum3_config

    return tum3_config().replace(tracking=TrackingConfig(enable_loop_closing=False),
                                 capacity=CapacityConfig(**small_capacity_kw()))


def random_descriptors(rng: np.random.Generator, n_rows: int) -> np.ndarray:
    return rng.integers(0, 2 ** 32, (n_rows, 8), dtype=np.uint64).astype(np.uint32)


def flip_bits(rng: np.random.Generator, desc: np.ndarray, p: float) -> np.ndarray:
    bits = (rng.random(desc.shape + (32,)) < p)
    mask = (bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)
    return desc ^ mask


@lru_cache(maxsize=None)
def jax_bootstrap(n_next: int = 8):
    """The reference's chunked tracker bootstrapped on the rendered arc, and
    the reference front end's Frames of the next ``n_next`` images. Returns
    (tracker, frames, timestamps, first index after bootstrap)."""
    from eao_slam_tpu.runtime.frame import frame_from_image
    from eao_slam_tpu.runtime.scan_tracker import ChunkedTracker

    ts, gt, images = rendered_arc()
    cfg = jax_config()
    tr = ChunkedTracker(cfg, chunk=n_next)
    i = 0
    while not tr.bootstrap(frame_from_image(cfg, images[i].astype(np.float32)), float(ts[i])):
        i += 1
    i += 1
    frames = [frame_from_image(cfg, images[k].astype(np.float32)) for k in range(i, i + n_next)]
    return tr, frames, ts[i:i + n_next], i


def jax_carry_numpy(c, with_table: bool = False) -> dict:
    """A reference ChunkCarry as the dict of numpy arrays convert.py takes;
    its object table too when ``with_table`` (the object-layer modes: in
    geometry mode the reference carries a one-slot dummy)."""
    d = {k: np.asarray(v) for k, v in c._asdict().items() if k not in ("m", "table", "obj_key")}
    d["m"] = {k: np.asarray(v) for k, v in c.m._asdict().items()}
    if with_table:
        d["table"] = {k: np.asarray(v) for k, v in c.table._asdict().items()}
    return d


def reference_draws_for(module, name, solver, seed: int, shape_of):
    """(module, name, replacement) for ``monkeypatch.setattr``: ``solver``
    (a port RANSAC) fed the reference's own draws. The reference splits
    its between-chunk loop key (``PRNGKey(seed + 7)``) once per RANSAC
    call and draws with ``jax.random.choice`` over the valid rows; the
    replacement does the same, in the same order, and passes the draws as
    ``hyp_idx``. ``shape_of(n_hyp)`` gives the draw's shape."""
    import jax

    key = [jax.random.PRNGKey(seed + 7)]

    def drawn(cam, *args, generator=None, n_hyp=None, hyp_idx=None, **kw):
        key[0], sub = jax.random.split(key[0])
        valid = n(args[2])
        p = jax.numpy.asarray(valid, jax.numpy.float32) / max(int(valid.sum()), 1)
        kw_n = {} if n_hyp is None else {"n_hyp": n_hyp}
        idx = np.asarray(jax.random.choice(sub, valid.shape[0], shape=shape_of(n_hyp), p=p))
        return solver(cam, *args, hyp_idx=t(idx), **kw_n, **kw)

    return module, name, drawn


@lru_cache(maxsize=None)
def feature_sequence():
    """The reference's chunked-tracker test sequence (tests/test_scan_tracker.py):
    a 40-degree arc of 50 frames through the room of seed 3, simulated at the
    feature level (256 features). Returns (timestamps, T_cw, observations)."""
    from eao_slam_torch.geometry.camera import TUM3
    from eao_slam_torch.io.synthetic import make_arc_trajectory, make_room_scene, simulate_observations

    scene = make_room_scene(seed=3, n_landmarks=1200, n_objects=3)
    ts, gt = make_arc_trajectory(n_frames=50, sweep_deg=40.0)
    rng = np.random.default_rng(7)
    obs = [simulate_observations(scene, TUM3, T, max_features=256, rng=rng, pixel_noise=0.4,
                                 bit_flips=6, dropout=0.05) for T in gt]
    return ts, gt, obs


def jax_feature_bootstrap(cfg):
    """A reference ChunkedTracker (loop closing on) bootstrapped on
    ``feature_sequence``. Returns (tracker, first index after bootstrap)."""
    from eao_slam_tpu.runtime.frame import frame_from_arrays
    from eao_slam_tpu.runtime.scan_tracker import ChunkedTracker

    ts, _, obs = feature_sequence()
    tr = ChunkedTracker(cfg, chunk=5)
    i = 0
    while tr.carry is None:
        o = obs[i]
        tr.bootstrap(frame_from_arrays(cfg, kp=o["kp"], desc=o["desc"], octave=o["octave"],
                                       valid=o["valid"]), float(ts[i]))
        i += 1
    return tr, i


def jax_mono_numpy(tr) -> dict:
    """A reference MonoTracker's state as the dict ``convert.
    mono_tracker_from_numpy`` takes (numpy arrays, uint32 descriptors)."""
    lc = tr.loop_closer
    d = {"map": {k: np.array(v) for k, v in tr.map._asdict().items()},
         "kf_slots": list(tr.kf_slots),
         "last_T": None if tr.last_T is None else np.array(tr.last_T),
         "velocity": None if tr.velocity is None else np.array(tr.velocity),
         "last_pt": None if tr.last_pt is None else np.array(tr.last_pt),
         "last_frame": None if tr.last_frame is None else
         {k: np.array(v) for k, v in tr.last_frame._asdict().items()},
         "obj_table": None if tr.obj_table is None else
         {k: np.array(v) for k, v in tr.obj_table._asdict().items()},
         "loop_closer": None if lc is None else {
             "signatures": lc.signatures.copy(), "consistent_streak": dict(lc.consistent_streak),
             "last_loop_order": lc.last_loop_order, "closed_loops": lc.closed_loops},
         "vocab": None if tr.vocab is None else {
             "levels": [np.array(x) for x in tr.vocab.levels], "idf": np.array(tr.vocab.idf)},
         "kfdb": None if tr.kfdb is None else {"vectors": tr.kfdb.vectors.copy(),
                                               "present": tr.kfdb.present.copy()},
         "localization_only": tr.localization_only}
    for k in ("kf_pt_host", "kf_valid_host", "pt_valid_host", "pt_first_kf_host"):
        d[k] = np.array(getattr(tr, k))
    for k in ("n_points", "state", "frame_id", "frames_since_kf", "ref_kf_tracked",
              "peak_since_kf"):
        d[k] = int(getattr(tr, k))
    return d


def jax_mono_from_numpy(d: dict, cfg):
    """A reference MonoTracker holding the state ``d`` (``jax_mono_numpy``)."""
    import jax.numpy as jnp

    from eao_slam_tpu.objects.state import ObjectTable
    from eao_slam_tpu.ops.bow import Vocabulary
    from eao_slam_tpu.runtime.frame import Frame
    from eao_slam_tpu.runtime.keyframe_db import KeyFrameDatabase
    from eao_slam_tpu.runtime.map_state import MapState
    from eao_slam_tpu.runtime.tracker import MonoTracker

    tr = MonoTracker(cfg)
    tr.map = MapState(**{k: jnp.asarray(v) for k, v in d["map"].items()})
    tr.kf_slots = list(d["kf_slots"])
    for k in ("kf_pt_host", "kf_valid_host", "pt_valid_host", "pt_first_kf_host"):
        setattr(tr, k, np.array(d[k]))
    for k in ("n_points", "state", "frame_id", "frames_since_kf", "ref_kf_tracked",
              "peak_since_kf"):
        setattr(tr, k, int(d[k]))
    tr.last_T = None if d["last_T"] is None else np.array(d["last_T"])
    tr.velocity = None if d["velocity"] is None else np.array(d["velocity"])
    tr.last_pt = None if d["last_pt"] is None else jnp.asarray(d["last_pt"])
    tr.last_frame = None if d["last_frame"] is None else \
        Frame(**{k: jnp.asarray(v) for k, v in d["last_frame"].items()})
    if d["obj_table"] is not None:
        tr.obj_table = ObjectTable(**{k: jnp.asarray(v) for k, v in d["obj_table"].items()})
    if d["loop_closer"] is not None:
        lc = d["loop_closer"]
        tr.loop_closer.signatures = lc["signatures"].copy()
        tr.loop_closer.consistent_streak = dict(lc["consistent_streak"])
        tr.loop_closer.last_loop_order = lc["last_loop_order"]
        tr.loop_closer.closed_loops = lc["closed_loops"]
    if d["vocab"] is not None:
        tr.vocab = Vocabulary(levels=tuple(jnp.asarray(x) for x in d["vocab"]["levels"]),
                              idf=jnp.asarray(d["vocab"]["idf"]))
        tr.kfdb = KeyFrameDatabase(tr.vocab, tr.cfg.capacity.max_keyframes)
        tr.kfdb.vectors = d["kfdb"]["vectors"].copy()
        tr.kfdb.present = d["kfdb"]["present"].copy()
    tr.localization_only = d["localization_only"]
    return tr
