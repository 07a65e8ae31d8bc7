"""Checks the parallel layer with one NCCL rank on each card of one host.

    python3 tools/multi_card_check.py          # every card of the machine (2 or more)
    python3 tools/multi_card_check.py --cpu 4  # 4 gloo ranks on the CPU, at the tiny profile

The parent renders the frames (on a card: the bench arc at the main
path's widths and the tilted arc of chip_smoke.py; with --cpu:
tests/test_multi_seq_engine.py's two tiny arcs at tiny_profile_config) and runs the single-device
references: System over the default seed's bootstrap, warm-up and one
chunk, each sequence tracked alone for two chunks (one on the CPU, whose
second arc bootstraps late), and bundle_adjust /
local_ba of a synthetic BA problem (chip_smoke.synthetic_ba_problem,
K = 8, P = 1000). Then it starts one rank per card (EAO_LOCAL_RANK = the
rank) through parallel.distributed.initialize_from_env: global_mesh's
folding, System(mesh="auto") over the same frames, a MultiSeqEngine with
one sequence a rank (the two sequences in turn), dist_ba on the "dev"
mesh, dist_ba2 direct and cg on the (host, device) mesh and the meshed
tracker's ba_solver. Gates: the trajectories equal the single device's
bit for bit (the single device repeats itself bit for bit on this path,
chip_smoke.py phase 13), every rank returns the same, the solvers within
chip_smoke.py's PAR_* bounds of the single-device solves, the mesh folded
as global_mesh's rule says (2 virtual hosts at 4 or more ranks) and
fast_nms_tile_max launched on every rank on a card. Prints the card's
name and power limit, each rank's seconds, then one JSON line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import chip_smoke as cs  # noqa: E402

ROUNDS = {"card": 2, "cpu": 1}   # MultiSeqEngine chunks after each bootstrap


def inputs(cpu: bool) -> dict:
    """Frames, configuration and chunk of the check."""
    from eao_slam_torch.io.synthetic import make_arc_trajectory, make_room_scene, render_image

    if not cpu:
        ts, _, images = cs.render_sequence()
        tilted = cs.rendered("tilted", cs.render_jobs()["tilted"])
        return {"cfg": cs.main_config(cs.SEEDS[0]), "chunk": cs.CHUNK,
                "seqs": [(ts, images), (ts[:cs.TILT_FRAMES], tilted)]}
    from eao_slam_torch.config import tiny_profile_config

    cfg = tiny_profile_config()
    seqs = []
    for seed in (5, 11):
        scene = make_room_scene(seed=seed, n_landmarks=100, n_objects=2)
        ts, gt = make_arc_trajectory(n_frames=8 + 2 * 8, sweep_deg=50.0)
        seqs.append((ts, np.stack([render_image(scene, cfg.camera, T) for T in gt])))
    return {"cfg": cfg, "chunk": 8, "seqs": seqs}


def prefix_run(sysm, ts, images, chunk: int) -> dict:
    """Bootstrap, one warm-up chunk and one more, then flush."""
    from eao_slam_torch.ops import fast_nms

    fast_nms.reset_launches()
    i = 0
    while i < len(images) and not sysm.tracker.armed:
        sysm.track_monocular(images[i], float(ts[i]))
        i += 1
    for k in range(i, min(i + 2 * chunk, len(images))):
        sysm.track_monocular(images[k], float(ts[k]))
    sysm.flush()
    t, T = sysm.tracker.frame_trajectory()
    return {"ts": t, "T": T, "launches": fast_nms.launches["fast_nms_tile_max"]}


def solvers(problem: dict, device, mesh_device) -> dict:
    from eao_slam_torch.geometry.camera import TUM3
    from eao_slam_torch.parallel.dist_ba import distributed_bundle_adjust, make_ba_mesh
    from eao_slam_torch.parallel.dist_ba2 import distributed_bundle_adjust_v2
    from eao_slam_torch.parallel.frames import make_frame_mesh
    from eao_slam_torch.runtime.scan_tracker import ChunkedTracker

    prob = cs._ba_problem(problem, device)
    out = {"dist_ba": cs._ba_host(distributed_bundle_adjust(TUM3, prob, make_ba_mesh(mesh_device),
                                                            iters=10))}
    tracker = ChunkedTracker(cs.main_config(cs.SEEDS[0]), chunk=cs.CHUNK, device=device,
                             mesh=make_frame_mesh(mesh_device))
    for method in ("direct", "cg"):
        out[f"v2_{method}"] = cs._ba_host(distributed_bundle_adjust_v2(
            TUM3, prob, tracker._ba_mesh, iters=10, method=method))
    out["ba_solver"] = cs._ba_host(tracker.ba_solver(TUM3, prob))
    out["ba_mesh"] = tracker._ba_mesh.ranks.tolist()
    return out


def rank_main(d: str) -> int:
    """One rank (``--rank DIR``): the checks above; writes DIR/rank<r>.npy."""
    import torch
    import torch.distributed as dist

    from eao_slam_torch.parallel.distributed import global_mesh, initialize_from_env, world
    from eao_slam_torch.parallel.multi_seq import MultiSeqEngine, make_seq_mesh
    from eao_slam_torch.system import System

    t0 = time.perf_counter()
    cpu = os.environ.get("EAO_CHECK_CPU") == "1"
    if cpu:
        torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    initialize_from_env(device="cpu" if cpu else None)
    rank, n = world()
    device = torch.device("cpu") if cpu else torch.device("cuda", torch.cuda.current_device())
    mesh_dev = "cpu" if cpu else None
    data = np.load(os.path.join(d, "inputs.npy"), allow_pickle=True).item()
    cfg, chunk, seqs = data["cfg"], data["chunk"], data["seqs"]
    out = {"rank": rank, "world": n, "backend": dist.get_backend(), "device": str(device),
           "global_mesh": global_mesh(device=mesh_dev).ranks.tolist()}
    t1 = time.perf_counter()
    sysm = System(cfg, chunk=chunk, device=device, mesh="auto")
    out["system_mesh"] = prefix_run(sysm, *seqs[0], chunk)
    out["system_mesh"]["seconds"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    eng = MultiSeqEngine(cfg, n_seq=n, chunk=chunk, mesh=make_seq_mesh(mesh_dev), device=device)
    mine = [seqs[s % 2] for s in range(n)]
    starts = []
    for s, (ts_s, im_s) in enumerate(mine):
        i = 0
        while i < len(im_s) and not eng.bootstrap(s, im_s[i], float(ts_s[i])):
            i += 1
        starts.append(i + 1)
    for k in range(ROUNDS["cpu" if cpu else "card"]):
        eng.track_images(np.stack([im[st + k * chunk: st + (k + 1) * chunk]
                                   for st, (_, im) in zip(starts, mine)]),
                         np.stack([ts_s[st + k * chunk: st + (k + 1) * chunk]
                                   for st, (ts_s, _) in zip(starts, mine)]))
    out["engine"] = {"frame": [eng.frame_trajectory(s) for s in range(n)],
                     "seconds": time.perf_counter() - t1}
    t1 = time.perf_counter()
    out["solvers"] = solvers(data["problem"], device, mesh_dev)
    out["solvers_seconds"] = time.perf_counter() - t1
    out["seconds"] = time.perf_counter() - t0
    np.save(os.path.join(d, f"rank{rank}.npy"), out, allow_pickle=True)
    dist.destroy_process_group()
    return 0


def main() -> int:
    import torch

    from eao_slam_torch.geometry.camera import TUM3
    from eao_slam_torch.solvers.ba import bundle_adjust, local_ba
    from eao_slam_torch.system import System

    if sys.argv[1:2] == ["--rank"]:
        return rank_main(sys.argv[2])
    cpu = sys.argv[1:2] == ["--cpu"]
    n = int(sys.argv[2]) if cpu else torch.cuda.device_count()
    if n < 2:
        print(f"multi_card_check: {n} card(s); the check needs 2 or more", file=sys.stderr)
        return 1
    device = torch.device("cpu" if cpu else "cuda")
    if cpu:
        torch.set_num_threads(1)
    else:
        print(cs.card_line())
        cs.RENDERS = cs.Renders({k: v for k, v in cs.render_jobs().items()
                                 if k in ("arc", "tilted")})
    try:
        data = inputs(cpu)
    finally:
        if cs.RENDERS is not None:
            cs.RENDERS.close()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, chunk, seqs = data["cfg"], data["chunk"], data["seqs"]
    t0 = time.perf_counter()
    single = prefix_run(System(cfg, chunk=chunk, device=device), *seqs[0], chunk)
    single["seconds"] = time.perf_counter() - t0
    solos = [cs.solo_run(cfg, ts, im, ROUNDS["cpu" if cpu else "card"], device=device,
                         chunk=chunk)["frame"] for ts, im in seqs]
    problem, _ = cs.synthetic_ba_problem(np.random.default_rng(3), K=8, P=1000)
    prob = cs._ba_problem(problem, device)
    ref = {"bundle_adjust": cs._ba_host(bundle_adjust(TUM3, prob, iters=10)),
           "local_ba": cs._ba_host(local_ba(TUM3, prob))}

    with tempfile.TemporaryDirectory() as d:
        np.save(os.path.join(d, "inputs.npy"), {**data, "problem": problem}, allow_pickle=True)
        env = dict(os.environ, EAO_COORDINATOR=f"localhost:{cs._free_port()}",
                   EAO_NUM_PROCESSES=str(n), EAO_CHECK_CPU="1" if cpu else "0")
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank", d],
                                  env=dict(env, EAO_PROCESS_ID=str(r), EAO_LOCAL_RANK=str(r)),
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(n)]
        try:
            logs = [p.communicate(timeout=cs.PAR_RANK_TIMEOUT_S)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                print(log[-6000:], file=sys.stderr)
                raise AssertionError(f"rank {r} exited {p.returncode}")
        ranks = [np.load(os.path.join(d, f"rank{r}.npy"), allow_pickle=True).item()
                 for r in range(n)]
        wall = time.perf_counter() - t0

    want_mesh = np.arange(n).reshape(2 if n >= 4 else 1, -1).tolist()
    bad = []
    for g in ranks:
        if g["global_mesh"] != want_mesh or g["solvers"]["ba_mesh"] != want_mesh:
            bad.append(f"rank {g['rank']}: meshes {g['global_mesh']}, {g['solvers']['ba_mesh']}")
        sm = (g["system_mesh"]["ts"], g["system_mesh"]["T"])
        if cs._traj_diff(sm, (single["ts"], single["T"])) != 0 or len(sm[0]) != len(single["ts"]):
            bad.append(f"rank {g['rank']}: System(mesh) differs from the single device")
        if not cpu and g["system_mesh"]["launches"] <= 0:
            bad.append(f"rank {g['rank']}: no fast_nms_tile_max launch")
        for s in range(n):
            if cs._traj_diff(g["engine"]["frame"][s], solos[s % 2]) != 0:
                bad.append(f"rank {g['rank']}: MultiSeqEngine sequence {s} differs from solo")
        for key in ("dist_ba", "v2_direct", "v2_cg", "ba_solver"):
            for f in ("poses", "points", "obs_inlier", "cost"):
                if not np.array_equal(g["solvers"][key][f], ranks[0]["solvers"][key][f]):
                    bad.append(f"rank {g['rank']}: {key} {f} differs from rank 0's")
    figures = {}
    for key, res in ranks[0]["solvers"].items():
        if key not in cs.PAR_POSE_TOL:
            continue
        r1 = ref["local_ba" if key == "ba_solver" else "bundle_adjust"]
        f = {"t_err": cs._t_err(res["poses"], r1["poses"]), "cost": float(res["cost"]),
             "single_cost": float(r1["cost"]),
             "inliers_shared": float(np.mean(res["obs_inlier"] == r1["obs_inlier"]))}
        figures[key] = f
        tol = cs.PAR_POSE_TOL[key]
        if not ((tol is None or f["t_err"] < tol)
                and f["cost"] <= cs.PAR_COST_FACTOR * f["single_cost"] + 1e-3
                and f["inliers_shared"] > cs.PAR_INLIER_AGREE):
            bad.append(f"{key} disagrees with the single device: {f}")
    summary = {"ranks": n, "backend": ranks[0]["backend"], "mesh": want_mesh,
               "system_mesh_poses": len(single["ts"]), "single_seconds": single["seconds"],
               "launches_by_rank": [g["system_mesh"]["launches"] for g in ranks],
               "seconds_by_rank": {k: [round(g[k]["seconds"] if isinstance(g[k], dict)
                                             else g[k], 3) for g in ranks]
                                   for k in ("system_mesh", "engine", "solvers_seconds",
                                             "seconds")},
               "wall_s": wall, "solvers": figures, "failures": bad}
    print(json.dumps(summary))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
