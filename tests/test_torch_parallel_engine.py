"""The port's parallel engine on gloo groups of 2 ranks: frame-sharded
extraction, System(mesh=...), MultiSeqEngine and its sync=False
deferral, against the single-process port (each rank's extraction, the
trajectories) and against the reference's own bars
(tests/test_parallel_frames.py, test_mesh_engine.py,
test_multi_seq_engine.py).

On the CPU the port's per-frame arithmetic does not depend on how many
frames a call extracts, so the sharded features, the mesh engine's
trajectory and every MultiSeqEngine sequence equal the single-process
results bit for bit (the reference holds its vmapped engine to 2e-4,
its XLA reductions being relaid out by the batch). Both ranks read every
sequence the same after ``drain()``.

The deferral is the reference's behaviour, pinned (its
``parallel/multi_seq.py:210``, ADVICE.md): with ``sync=False`` map
maintenance waits for ``drain()``, so the keyframe allocator passes the
headroom that maintenance keeps (max_keyframes - max(8, chunk / 2))
while chunks are deferred, and maintenance runs only at the drain. A
guard belongs to both packages."""

import numpy as np
import pytest
import torch

from eao_slam_torch.config import CapacityConfig, tiny_profile_config, tum3_config
from eao_slam_torch.geometry.camera import TUM3
from eao_slam_torch.io.synthetic import make_arc_trajectory, make_room_scene, render_image
from eao_slam_torch.ops.orb import extract_orb
from eao_slam_torch.runtime.frame import frame_from_image
from eao_slam_torch.runtime.scan_tracker import ChunkedTracker
from eao_slam_torch.system import System
from torch_parallel import drive_system, run_ranks
import torch_parity  # noqa: F401  (one intra-op thread, as each rank runs)

CHUNK = 8
TINY_CAM = tiny_profile_config().camera


@pytest.fixture(scope="module")
def extract_images():
    return np.random.default_rng(12345).uniform(0, 255, (8, 96, 128)).astype(np.float32)


@pytest.fixture(scope="module")
def multi_seqs():
    """tests/test_multi_seq_engine.py's two sequences (scenes 5 and 11)."""
    out = []
    for seed in (5, 11):
        scene = make_room_scene(seed=seed, n_landmarks=100, n_objects=2)
        ts, gt = make_arc_trajectory(n_frames=8 + 2 * CHUNK, sweep_deg=50.0)
        out.append((ts, np.stack([render_image(scene, TINY_CAM, T) for T in gt])))
    return out


@pytest.fixture(scope="module")
def deferral_seq():
    """A longer, wider run of the first scene, for the deferral: enough
    chunks that the keyframe allocator passes the headroom (12 keyframes
    of 16 after five chunks, where maintenance starts above 8)."""
    scene = make_room_scene(seed=5, n_landmarks=100, n_objects=2)
    ts, gt = make_arc_trajectory(n_frames=8 + 6 * CHUNK, sweep_deg=120.0)
    return ts, np.stack([render_image(scene, TINY_CAM, T) for T in gt])


@pytest.fixture(scope="module")
def ranks(extract_images, multi_seqs, deferral_seq, tmp_path_factory):
    return run_ranks(2, tmp_path_factory.mktemp("engine_ranks"), "engine_suite",
                     extract_images, None, multi_seqs, deferral_seq)


def solo(seq, cfg, rounds: int) -> tuple:
    """The sequence tracked alone by a ChunkedTracker: bootstrap, then
    ``rounds`` full chunks (the reference test's protocol)."""
    ts, imgs = seq
    t = ChunkedTracker(cfg, chunk=CHUNK, device="cpu")
    i = 0
    while i < len(imgs) and t.carry is None:
        t.bootstrap(frame_from_image(cfg, imgs[i], "cpu"), float(ts[i]))
        i += 1
    start = i
    for _ in range(rounds):
        t.track_images(imgs[i:i + CHUNK], ts[i:i + CHUNK])
        i += CHUNK
    return start, t.frame_trajectory(), t.keyframe_trajectory(), t.state


def test_sharded_extraction_equals_per_frame(ranks, extract_images):
    """extract_batch_sharded over 2 ranks gives every frame's per-frame
    extract_orb features bit for bit, on both ranks."""
    for r in (0, 1):
        got = ranks[r]["extract"]
        for c in range(len(extract_images)):
            ref = extract_orb(torch.as_tensor(extract_images[c:c + 1]), n_features=128,
                              n_levels=3)
            for f in ref._fields:
                np.testing.assert_array_equal(got[f][c], getattr(ref, f)[0].numpy(), err_msg=f)


def test_multi_seq_engine_equals_solo_runs(ranks, multi_seqs):
    """Each rank tracks one of the two sequences; after each chunk's drain
    both ranks read both sequences, equal to the solo runs bit for bit
    (frame and keyframe trajectories, states)."""
    cfg = tiny_profile_config()
    assert [ranks[r]["owned"] for r in (0, 1)] == [[0], [1]]
    rounds = ranks[0]["multi_seq"]["rounds"]
    assert rounds >= 1
    for s, seq in enumerate(multi_seqs):
        start, (ts_s, T_s), (kts, kT), state = solo(seq, cfg, rounds)
        assert state == 2
        for r in (0, 1):
            got = ranks[r]["multi_seq"]
            assert got["starts"][s] == start
            assert got["rounds"] == rounds
            assert got["state"][s] == 2
            np.testing.assert_array_equal(got["frame"][s][0], ts_s)
            np.testing.assert_array_equal(got["frame"][s][1], T_s)
            np.testing.assert_array_equal(got["keyframe"][s][0], kts)
            np.testing.assert_array_equal(got["keyframe"][s][1], kT)


def test_sync_false_defers_maintenance_past_the_headroom(ranks):
    """Pinned reference behaviour: with sync=False no deferred chunk runs
    maintenance, although the keyframe allocator passes the headroom
    maintenance keeps; the drain replays every chunk's records and then
    runs it once."""
    d = ranks[0]["deferral"]
    limit = d["max_keyframes"] - d["headroom"]
    assert all(s["maintenance"] == 0 for s in d["steps"])
    assert all(s["records"] == d["boot_records"] for s in d["steps"])
    assert max(s["kf_count"] for s in d["steps"]) > limit
    assert d["after_drain"]["maintenance"] == 1
    assert d["after_drain"]["records"] == d["boot_records"] + d["frames"]
    assert ranks[1]["deferral"] == d


@pytest.fixture(scope="module")
def mesh_seq():
    """tests/test_mesh_engine.py's 24-frame sequence at 640x480."""
    scene = make_room_scene(seed=5, n_landmarks=200, n_objects=3)
    ts, gt = make_arc_trajectory(n_frames=24, sweep_deg=45.0)
    return ts, np.stack([render_image(scene, TUM3, T) for T in gt])


@pytest.mark.slow
def test_mesh_engine_matches_single_process(mesh_seq, extract_images, multi_seqs,
                                            tmp_path_factory):
    """System(mesh=2 ranks) gives System()'s trajectory bit for bit on both
    ranks, and mesh="auto" arms the frame mesh and the (1, 2) BA mesh
    (the reference's test_mesh_engine_matches_single_device, slow there
    too)."""
    ranks = run_ranks(2, tmp_path_factory.mktemp("mesh_engine"), "engine_suite",
                      extract_images, mesh_seq, multi_seqs, None)
    cfg = tum3_config().replace(capacity=CapacityConfig(
        max_keyframes=64, max_points=4096, max_features=256, local_ba_points=1024))
    want = drive_system(System(cfg, chunk=8, device="cpu"), *mesh_seq)
    assert want["state"] == 2
    for r in (0, 1):
        got = ranks[r]["system_mesh"]
        assert got["state"] == 2
        np.testing.assert_array_equal(got["ts"], want["ts"])
        np.testing.assert_array_equal(got["T"], want["T"])
        assert ranks[r]["auto_mesh"] == 2
        assert ranks[r]["auto_ba_mesh"] == [[0, 1]]
