"""Rank groups for the parallel layer's CPU tests: ``run_ranks`` starts n
processes that join a gloo group through a FileStore in a temporary
directory (no TCP port, so test files run side by side), each running
one of the suites below on the same inputs; it returns each rank's
result. The suites import the port only: a rank never loads JAX."""

from __future__ import annotations

import multiprocessing
import os
import traceback

import numpy as np


def _entry(rank: int, n: int, store: str, fn_name: str, args: tuple, queue) -> None:
    try:
        import torch

        torch.set_num_threads(1)
        os.environ.update(EAO_COORDINATOR=f"file://{store}", EAO_NUM_PROCESSES=str(n),
                          EAO_PROCESS_ID=str(rank))
        from eao_slam_torch.parallel.distributed import initialize_from_env

        assert initialize_from_env(device="cpu", timeout_s=300)
        out = globals()[fn_name](*args)
        import torch.distributed as dist

        dist.destroy_process_group()
        queue.put((rank, out, None))
    except BaseException:
        queue.put((rank, None, traceback.format_exc()))


def run_ranks(n: int, tmpdir: str, fn_name: str, *args, timeout: float = 900.0) -> list:
    """Run suite ``fn_name(*args)`` on n gloo ranks; the list of results in
    rank order. A rank's exception is raised here with its traceback."""
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    store = os.path.join(str(tmpdir), f"store_{fn_name}_{n}")
    procs = [ctx.Process(target=_entry, args=(r, n, store, fn_name, args, queue))
             for r in range(n)]
    for p in procs:
        p.start()
    results, errors = [None] * n, []
    try:
        for _ in range(n):
            rank, out, err = queue.get(timeout=timeout)
            results[rank] = out
            if err:
                errors.append(f"rank {rank}:\n{err}")
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    if errors:
        raise AssertionError("\n".join(errors))
    return results


# ---------------------------------------------------------------------------
# helpers the suites share
# ---------------------------------------------------------------------------

def ba_problem(fields: dict):
    """A port BAProblem on the CPU from numpy fields."""
    import torch

    from eao_slam_torch.solvers.ba import BAProblem

    return BAProblem(**{k: torch.as_tensor(np.array(v)) for k, v in fields.items()})


def _result(res) -> dict:
    return {k: getattr(res, k).detach().cpu().numpy() for k in res._fields}


# ---------------------------------------------------------------------------
# suites
# ---------------------------------------------------------------------------

def ba_suite(problems: dict, batch: list) -> dict:
    """Every solver of the parallel layer on this group: the meshes'
    shapes, dist_ba, dist_ba2 (direct and cg, with and without a fixed
    two-camera gauge), the chunked tracker's ba_solver beside the
    single-device 5 + 10 schedule and batch_bundle_adjust over ``batch``."""
    from eao_slam_torch.config import CapacityConfig, tum3_config
    from eao_slam_torch.geometry.camera import TUM3
    from eao_slam_torch.parallel.dist_ba import distributed_bundle_adjust, make_ba_mesh
    from eao_slam_torch.parallel.dist_ba2 import distributed_bundle_adjust_v2
    from eao_slam_torch.parallel.distributed import global_mesh
    from eao_slam_torch.parallel.frames import make_frame_mesh
    from eao_slam_torch.parallel.multi_seq import batch_bundle_adjust
    from eao_slam_torch.runtime.scan_tracker import ChunkedTracker

    out = {"global_mesh": global_mesh(device="cpu").ranks.tolist(),
           "global_mesh_1": global_mesh(1, device="cpu").ranks.tolist()}
    mesh = make_ba_mesh("cpu")
    for name, p in problems.items():
        out[f"dist_ba/{name}"] = _result(distributed_bundle_adjust(TUM3, ba_problem(p), mesh,
                                                                   iters=8))
    cfg = tum3_config().replace(capacity=CapacityConfig(
        max_keyframes=64, max_points=4096, max_features=256, local_ba_points=1024))
    tracker = ChunkedTracker(cfg, chunk=8, device="cpu", mesh=make_frame_mesh("cpu"))
    hd = tracker._ba_mesh
    out["ba_mesh"] = hd.ranks.tolist()
    for name, p in problems.items():
        for method in ("direct", "cg"):
            out[f"v2_{method}/{name}"] = _result(distributed_bundle_adjust_v2(
                TUM3, ba_problem(p), hd, iters=8, n_cg=30, method=method))
    out["ba_solver"] = _result(tracker.ba_solver(TUM3, ba_problem(problems["K5P256"])))
    out["batch"] = [_result(r) for r in batch_bundle_adjust(
        TUM3, [ba_problem(p) for p in batch], make_ba_mesh("cpu"), iters=8)]
    return out


def engine_suite(extract_images: np.ndarray, mesh_seq, multi_seqs, deferral_seq) -> dict:
    """The engine side on this group: sharded extraction, System(mesh=...)
    and System(mesh="auto") on the mesh-engine sequence, MultiSeqEngine on
    two sequences (sync) and the sync=False deferral."""
    import torch

    from eao_slam_torch.config import CapacityConfig, tiny_profile_config, tum3_config
    from eao_slam_torch.parallel.frames import extract_batch_sharded, make_frame_mesh
    from eao_slam_torch.parallel.multi_seq import MultiSeqEngine, make_seq_mesh
    from eao_slam_torch.system import System

    out = {}
    feats = extract_batch_sharded(torch.as_tensor(extract_images), make_frame_mesh("cpu"),
                                  n_features=128, n_levels=3)
    out["extract"] = {k: getattr(feats, k).numpy() for k in feats._fields}

    if mesh_seq is not None:
        ts, images = mesh_seq
        cfg = tum3_config().replace(capacity=CapacityConfig(
            max_keyframes=64, max_points=4096, max_features=256, local_ba_points=1024))
        sysm = System(cfg, chunk=8, device="cpu", mesh=make_frame_mesh("cpu"))
        out["system_mesh"] = drive_system(sysm, ts, images)
        auto = System(cfg, chunk=8, device="cpu", mesh="auto")
        out["auto_mesh"] = None if auto.tracker.mesh is None else auto.tracker.mesh.size
        out["auto_ba_mesh"] = auto.tracker._ba_mesh.ranks.tolist()

    eng = MultiSeqEngine(tiny_profile_config(), n_seq=len(multi_seqs), chunk=8,
                         mesh=make_seq_mesh("cpu"))
    out["multi_seq"] = drive_multi_seq(eng, multi_seqs, sync=True)
    out["owned"] = list(eng.owned)
    if deferral_seq is not None:
        out["deferral"] = deferral_run(deferral_seq, make_seq_mesh("cpu"))
    return out


def drive_system(sysm, ts, images) -> dict:
    """The mesh-engine protocol: every frame through track_monocular, then
    flush(); the frame trajectory."""
    for i in range(len(images)):
        sysm.track_monocular(images[i], float(ts[i]))
    sysm.flush()
    t, T = sysm.tracker.frame_trajectory()
    return {"ts": t, "T": T, "state": sysm.tracker.state}


def bootstrap_all(eng, seqs) -> list:
    """Bootstrap every sequence frame by frame; each one's first chunk
    frame."""
    starts = []
    for s, (ts, images) in enumerate(seqs):
        i = 0
        while i < len(images) and not eng._armed[s]:
            eng.bootstrap(s, images[i], float(ts[i]))
            i += 1
        starts.append(i)
    return starts


def drive_multi_seq(eng, seqs, sync: bool = True) -> dict:
    """Bootstrap, then as many full chunks as every sequence has after its
    own bootstrap; every sequence's trajectories as this rank reads them."""
    starts = bootstrap_all(eng, seqs)
    C = eng.chunk
    rounds = min((len(seqs[s][0]) - starts[s]) // C for s in range(len(seqs)))
    for k in range(rounds):
        eng.track_images(np.stack([im[st + k * C: st + (k + 1) * C]
                                   for st, (_, im) in zip(starts, seqs)]),
                         np.stack([ts[st + k * C: st + (k + 1) * C]
                                   for st, (ts, _) in zip(starts, seqs)]), sync=sync)
    if not sync:
        eng.drain()
    return {"starts": starts, "rounds": rounds,
            "frame": [eng.frame_trajectory(s) for s in range(eng.n_seq)],
            "keyframe": [eng.keyframe_trajectory(s) for s in range(eng.n_seq)],
            "state": [eng.state(s) for s in range(eng.n_seq)]}


def deferral_run(seq, mesh) -> dict:
    """One sequence per rank, every chunk with sync=False: the keyframe
    count and maintenance passes of this rank's tracker after each
    deferred chunk, then after drain()."""
    from eao_slam_torch.config import tiny_profile_config
    from eao_slam_torch.parallel.multi_seq import MultiSeqEngine

    n = mesh.size if mesh is not None else 1
    eng = MultiSeqEngine(tiny_profile_config(), n_seq=n, chunk=8, mesh=mesh)
    seqs = [seq] * n
    starts = bootstrap_all(eng, seqs)
    t = eng.trackers[eng.owned[0]]
    C = eng.chunk
    steps = []
    k = 0
    while starts[0] + (k + 1) * C <= len(seq[0]):
        lo = starts[0] + k * C
        eng.track_images(np.stack([im[lo:lo + C] for _, im in seqs]),
                         np.stack([ts[lo:lo + C] for ts, _ in seqs]), sync=False)
        outs = eng._outs[eng.owned[0]][-1]
        steps.append({"kf_count": int(outs.kf_count[-1]), "maintenance": t.n_maintenance,
                      "records": len(t.records)})
        k += 1
    eng.drain()
    headroom = max(8, C // 2)
    return {"steps": steps, "after_drain": {"kf_count": t.kf_count_host,
                                            "maintenance": t.n_maintenance,
                                            "records": len(t.records)},
            "max_keyframes": t.cfg.capacity.max_keyframes, "headroom": headroom,
            "frames": k * C, "boot_records": starts[0]}
