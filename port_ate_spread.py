"""Spread of the port's bench-arc ATE over RANSAC seeds, on one NVIDIA GPU.

    python3 port_ate_spread.py [--flag EAO|LineAndiForest] [--seeds 7 8 9 ...] [--device cpu]
    python3 port_ate_spread.py --flag LineAndiForest --seeds 5 --record-yaw DIR
    python3 port_ate_spread.py --interactive [--flag EAO] [--seeds ...] [--device cpu]
    python3 port_ate_spread.py --interactive --device cpu --replay-init DIR [--seeds ...]
    python3 port_ate_spread.py --interactive --device cpu --ref-ba-rounding [--seeds ...]
    python3 port_ate_spread.py --cli-test DIR [--scenes 4 5 ...] [--seeds ...] [--device cpu] \
        [--replay-init DIR]
    python3 port_ate_spread.py --summarize NAME=LOG[,LOG...] NAME=LOG ... [--early 5]

The counterpart of reference_ate_spread.py for the port: chip_smoke.py's
main path (geometry mode, or with ``--flag EAO`` its EAO phase and with
``--flag LineAndiForest`` its line phase, with bench.py's boxes; bench
capacities, the rendered 60-degree arc, bootstrap, a warm-up chunk, four
timed chunks of 32 frames) once per seed, with no gate. Prints one JSON
line per seed with the frames tracked and the sim3 ATE of the timed
frames (with the object layer also the live objects, each scene object's
centre error, and each live object's elected yaw and yaw votes), then the
median and the worst. ``--device cpu``
runs the port on the host instead (about ten minutes a seed in EAO mode):
the same code on other arithmetic, to tell the card's share of a spread
from the port's. ``--record-yaw DIR`` (line mode) keeps every call of the
object pass's two yaw functions, ``yaw_sample_scores`` and ``update_yaw``,
with its inputs and outputs, and writes them to
``DIR/yaw_calls_seed<seed>.npz``; ``reference_ate_spread.py --replay-yaw``
runs the reference's functions on the same inputs. The recording copies
every call to the host, so a recorded run's fps is not the program's.
``--interactive`` runs the interactive per-frame tracker instead
(System(chunked=False), every frame of the arc through track_monocular,
chip_smoke.py's ``drive_interactive``, the protocol of
``reference_ate_spread.py --interactive``): per seed the frame that
initialized, the frames tracked after it, the sim3 ATE of every tracked
frame (and the objects with ``--flag EAO``), the live points at the end,
the points each keyframe's triangulations added (``tri_points_per_kf``)
and each two-view initialization attempt (``init_attempts``: frame,
success, points), then the median and the worst. ``--replay-init DIR``
feeds the reference's hypothesis draws, recorded by
``reference_ate_spread.py --interactive --record-init DIR``, into the
port's ``initialize_two_view`` (its ``hyp_idx``) attempt by attempt, and
stops with an error where an attempt's valid-match mask differs from the
reference's: the port with the reference's draws, to tell the
initializer's random draw from the rest of the tracker. A seed whose
replay stops prints its reason (``stopped``); the other seeds go on, and
the script then exits 1. ``--ref-ba-rounding`` runs the interactive
protocol with the port's windowed and global BA assembling its normal
equations from terms rounded as the reference's one-hot matmuls round them
(each term split into two bfloat16 halves, about 16 mantissa bits;
``ref_rounding_lm_system``), still summed in float64: the port with the
reference's assembly arithmetic, to tell that arithmetic's share of a
spread.

``--cli-test DIR`` runs the port's ``cli.run_mono_tum("EAO", ...)``, as
tests/test_torch_cli.py's slow test does, on that test's 26-frame
sequence (a 22-degree arc of ``make_room_scene(seed=S, n_landmarks=60,
n_objects=2)``, PNGs, rgb.txt and yolo_txts/, no ground truth), one
sequence per scene seed S of ``--scenes`` (4, the test's, by default),
written to DIR/scene<S>/ unless it is there (``reference_ate_spread.py
--cli-test`` reads the same files), and once per RANSAC seed (the
configuration's ``seed``; 12345 is the command line's). Per run it prints
the frames tracked, the keyframes, the test's ATE (FrameTrajectory.txt
against the truth at the nearest stamp) and the init attempts. With
``--replay-init DIR`` the init attempts take the reference's draws from
DIR/``cli_init_draws_scene<S>_seed<R>.npz``.

``--summarize`` reads the per-seed JSON lines that this script and
reference_ate_spread.py print (and the seeds of chip_smoke.py's
interactive result line), one group of logs per NAME, and prints for
each group the runs, the stopped replays, the median and worst ATE and
the medians of the runs that initialized at frame ``--early`` (5) or
earlier and later;
for each pair of groups the two-sided Mann-Whitney p of their ATEs, and
on the seeds where both initialized on the same frame both medians and
how often the first is worse; with the object layer, per object class,
both groups' medians of the live objects' member points and extents per
axis (``object_extents``, map units) with the p of each.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

import numpy as np

import chip_smoke

INIT_DRAWS = "init_draws_seed{}.npz"
CLI_INIT_DRAWS = "cli_init_draws_scene{}_seed{}.npz"
CLI_TEST_FRAMES, CLI_TEST_SWEEP_DEG, CLI_TEST_BOXES = 26, 22.0, 8
TABLE_FIELDS = ("valid", "cls", "center", "cub_min", "cub_max", "yaw", "yaw_hist")
CALL_ARGS = ("targets", "boxes", "T_cw", "lines", "line_valid")


class YawCalls:
    """While entered, scan_tracker's names for the two yaw functions point
    to wrappers that keep a host copy of each call's table fields
    (``in_<field>``), arguments, scores (``counts``, ``errs``,
    ``n_lines``) and updated ``yaw_hist`` / ``yaw`` (``out_<field>``)."""

    def __enter__(self):
        from eao_slam_torch.runtime import scan_tracker

        self.module = scan_tracker
        self.saved = score, update = scan_tracker.yaw_sample_scores, scan_tracker.update_yaw
        self.calls = []

        def host(x):
            return x.detach().cpu().numpy()

        def recorded_score(cam, table, *args):
            out = score(cam, table, *args)
            call = {f"in_{f}": host(getattr(table, f)) for f in TABLE_FIELDS}
            call.update({k: host(a) for k, a in zip(CALL_ARGS, args)})
            call.update({k: host(x) for k, x in zip(("counts", "errs", "n_lines"), out)})
            self.calls.append(call)
            return out

        def recorded_update(table, *args):
            out = update(table, *args)
            self.calls[-1].update(out_yaw_hist=host(out.yaw_hist), out_yaw=host(out.yaw))
            return out

        scan_tracker.yaw_sample_scores, scan_tracker.update_yaw = recorded_score, recorded_update
        return self

    def __exit__(self, *exc):
        self.module.yaw_sample_scores, self.module.update_yaw = self.saved

    def save(self, path: str) -> None:
        np.savez_compressed(path, **{k: np.stack([c[k] for c in self.calls])
                                     for k in self.calls[0]})


def ref_round(x):
    """Each term as the reference's one-hot matmul takes it
    (eao_slam_tpu/solvers/ba.py ``_mm``): ``hi = bf16(x)``, ``lo = bf16(x -
    hi)``, the term ``hi + lo`` (exact in float32, about 16 mantissa bits)."""
    import torch

    hi = x.to(torch.bfloat16).to(x.dtype)
    return hi + (x - hi).to(torch.bfloat16).to(x.dtype)


def ref_rounding_lm_system(cam, prob, poses, points):
    """eao_slam_torch.solvers.ba._lm_system with every observation's term
    rounded by ``ref_round`` before the float64 sum: the port's assembly
    with the reference's per-term rounding and no other change."""
    import torch

    from eao_slam_torch.solvers import ba

    r, Jc, Jp, depth_ok = ba._residuals(cam, prob, poses, points)
    w, cost = ba._weights(prob, r, depth_ok)
    K, P, O = prob.poses.shape[0], prob.points.shape[0], r.shape[0]
    wJc, wJp = Jc * w[:, None, None], Jp * w[:, None, None]
    kf, pt = prob.kf_idx.long(), prob.pt_idx.long()

    def seg_sum(n_rows, idx, x):
        out = torch.zeros((n_rows, x.shape[1]), dtype=torch.float64, device=x.device)
        return out.index_add_(0, idx, ref_round(x).to(torch.float64)).to(x.dtype)

    Hcc = seg_sum(K, kf, torch.einsum("oki,okj->oij", wJc, Jc).reshape(O, 36)).reshape(K, 6, 6)
    bc = seg_sum(K, kf, torch.einsum("oki,ok->oi", wJc, r))
    Hpp = seg_sum(P, pt, torch.einsum("oki,okj->oij", wJp, Jp).reshape(O, 9)).reshape(P, 3, 3)
    bp = seg_sum(P, pt, torch.einsum("oki,ok->oi", wJp, r))
    Wcp = seg_sum(K * P, kf * P + pt,
                  torch.einsum("oki,okj->oij", wJc, Jp).reshape(O, 18)).reshape(K, P, 6, 3)
    return Hcc, Hpp, Wcp, bc, bp, cost


@contextlib.contextmanager
def ref_ba_rounding(on: bool = True):
    """While entered (and ``on``), the port's BA assembles its normal
    equations with ``ref_rounding_lm_system``."""
    from eao_slam_torch.solvers import ba

    saved = ba._lm_system
    if on:
        ba._lm_system = ref_rounding_lm_system
    try:
        yield
    finally:
        ba._lm_system = saved


class ReplayDiverged(RuntimeError):
    """A replayed init attempt cannot take the reference's draw."""


class InitAttempts:
    """While entered, a MonoTracker module's name for ``initialize_two_view``
    (either package's ``runtime.tracker``) points to a wrapper that notes
    each attempt's frame, success and initial points in ``attempts``. With
    ``replay`` (the arrays of a ``reference_ate_spread.py --record-init``
    file) the port's attempts take the reference's hypothesis indices, and
    an attempt whose valid-match mask differs from the reference's raises.
    ``frame`` is set by the caller before each frame."""

    def __init__(self, module, replay=None, draw=None):
        self.module, self.replay, self.draw = module, replay, draw
        self.attempts, self.frame = [], -1

    def __enter__(self):
        fn = self.saved = self.module.initialize_two_view

        def wrapped(cam, uv1, uv2, valid, *args, **kw):
            a = len(self.attempts)
            extra = {}
            if self.draw is not None:         # the reference: keep its draw and inputs
                extra["hyp_idx"] = np.asarray(self.draw(valid, args[0]))
                extra["ok"] = np.asarray(valid)
                extra.update(uv1=np.asarray(uv1), uv2=np.asarray(uv2),
                             key=np.asarray(args[0]), sigma=kw.get("sigma", 1.0),
                             min_triangulated=kw["min_triangulated"])
            if self.replay is not None:       # the port: take the reference's
                import torch

                if a >= len(self.replay["ok"]):
                    raise ReplayDiverged(f"init attempt {a} at frame {self.frame}: the "
                                         f"reference made only {len(self.replay['ok'])}")
                ok = valid.cpu().numpy()
                if not np.array_equal(ok, self.replay["ok"][a]):
                    raise ReplayDiverged(
                        f"init attempt {a} at frame {self.frame}: the valid-match mask differs "
                        f"from the reference's in {int((ok != self.replay['ok'][a]).sum())} rows")
                kw["hyp_idx"] = torch.as_tensor(self.replay["hyp_idx"][a], device=valid.device)
            res = fn(cam, uv1, uv2, valid, *args, **kw)
            self.attempts.append({"frame": self.frame, "success": bool(res.success),
                                  "points": int(chip_smoke._np(res.point_ok).sum()),
                                  **extra})
            return res

        self.module.initialize_two_view = wrapped
        return self

    def __exit__(self, *exc):
        self.module.initialize_two_view = self.saved

    def summary(self) -> list:
        return [{k: a[k] for k in ("frame", "success", "points")} for a in self.attempts]

    def save(self, path: str) -> None:
        """All attempts: the draws, the valid-match masks (``ok``), each
        attempt's matched pixels (``uv1``, ``uv2``), key, sigma and
        ``min_triangulated``, and its frame, success and points."""
        keys = ("hyp_idx", "ok", "uv1", "uv2", "key", "sigma", "min_triangulated",
                "frame", "success", "points")
        np.savez_compressed(path, **{k: np.stack([np.asarray(a[k]) for a in self.attempts])
                                     for k in keys})


def count_triangulations(tracker) -> list:
    """Wrap a MonoTracker's (either package's) ``_triangulate_new_points``
    so that each call appends (keyframe slot, points added) to the list it
    returns."""
    calls = []
    fn = tracker._triangulate_new_points

    def counted(slot, nb):
        n0 = int(tracker.pt_valid_host.sum())
        fn(slot, nb)
        calls.append((int(slot), int(tracker.pt_valid_host.sum()) - n0))

    tracker._triangulate_new_points = counted
    return calls


def drive_recorded(sysm, ts, gt, images, boxes, attempts: InitAttempts) -> dict:
    """chip_smoke.drive_interactive with the init attempts and the points
    each keyframe's triangulations added."""
    tri = count_triangulations(sysm.tracker)
    step = sysm.track_monocular

    def track(img, t, boxes=None):
        attempts.frame += 1
        return step(img, t, boxes=boxes)

    sysm.track_monocular = track
    r = chip_smoke.drive_interactive(sysm, ts, gt, images, boxes)
    per_kf = {}
    for slot, n in tri:
        per_kf[slot] = per_kf.get(slot, 0) + n
    return {**r, "tri_points_per_kf": list(per_kf.values()), "init_attempts": attempts.summary()}


def write_cli_test_sequence(d: str, scene_seed: int):
    """tests/test_cli.py's sequence on scene ``scene_seed`` as a TUM
    directory (the port's renderer, ``viz.raster.save_png``), written
    unless ``d`` holds it; returns the stamps (from 0) and true poses."""
    from eao_slam_torch.geometry.camera import TUM3
    from eao_slam_torch.io.synthetic import (make_arc_trajectory, make_room_scene,
                                             project_boxes, render_image)
    from eao_slam_torch.viz.raster import save_png

    ts, gt = make_arc_trajectory(n_frames=CLI_TEST_FRAMES, sweep_deg=CLI_TEST_SWEEP_DEG)
    if os.path.exists(os.path.join(d, "rgb.txt")):
        return ts, gt
    scene = make_room_scene(seed=scene_seed, n_landmarks=60, n_objects=2)
    os.makedirs(os.path.join(d, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(d, "yolo_txts"), exist_ok=True)
    rows = []
    for i, T in enumerate(gt):
        stamp = f"{chip_smoke.STAMP0 + ts[i]:.6f}"
        save_png(os.path.join(d, "rgb", f"{stamp}.png"), render_image(scene, TUM3, T))
        rows.append(f"{stamp} rgb/{stamp}.png")
        bxs, cls, score, valid = project_boxes(scene, TUM3, T, CLI_TEST_BOXES)
        with open(os.path.join(d, "yolo_txts", f"{stamp}.txt"), "w") as f:
            for b in np.flatnonzero(valid):
                x, y, w, h = bxs[b]
                f.write(f"{cls[b]} {x:.1f} {y:.1f} {w:.1f} {h:.1f} {score[b]:.2f}\n")
    with open(os.path.join(d, "rgb.txt"), "w") as f:
        f.write("# timestamp filename\n" + "\n".join(rows) + "\n")
    return ts, gt


def cli_test_run(cli, tracker, seq: str, ts, gt, seed: int, replay=None, draw=None,
                 **kw) -> tuple:
    """Either package's ``cli.run_mono_tum("EAO", seq, ...)`` with the
    RANSAC seed ``seed`` and the init attempts of ``tracker`` (that
    package's ``runtime.tracker``) recorded (``InitAttempts``, with its
    ``replay`` or ``draw``); returns the run's figures and the attempts."""
    import tempfile

    from eao_slam_torch.io.trajectory import ate_rmse

    base, step = cli.tum3_config, cli.System.track_monocular
    attempts = InitAttempts(tracker, replay, draw)

    def counted(self, *a, **k):
        attempts.frame += 1
        return step(self, *a, **k)

    cli.tum3_config = lambda flag: base(flag).replace(seed=seed)
    cli.System.track_monocular = counted
    try:
        with attempts, tempfile.TemporaryDirectory() as out:
            stats = cli.run_mono_tum("EAO", seq, out, **kw)
            rows = open(os.path.join(out, "FrameTrajectory.txt")).read().strip().splitlines()
    finally:
        cli.tum3_config, cli.System.track_monocular = base, step
    est = np.asarray([[float(v) for v in r.split()] for r in rows])
    idx = [int(np.argmin(np.abs((chip_smoke.STAMP0 + ts) - t))) for t in est[:, 0]]
    gt_c = np.stack([-T[:3, :3].T @ T[:3, 3] for T in gt[idx]])
    init = [a["frame"] for a in attempts.attempts if a["success"]]
    return {"seed": seed, "frames_tracked": stats["frames_tracked"],
            "keyframes": stats["keyframes"], "ate_m": float(ate_rmse(est[:, 1:4], gt_c)),
            "init_frame": init[0] if init else None,
            "init_attempts": attempts.summary()}, attempts


def cli_test(args) -> int:
    """--cli-test: the port's run_mono_tum per scene and RANSAC seed."""
    from eao_slam_torch import cli
    from eao_slam_torch.runtime import tracker

    stopped = 0
    for scene in args.scenes:
        seq = os.path.join(args.cli_test, f"scene{scene}")
        ts, gt = write_cli_test_sequence(seq, scene)
        for seed in args.seeds:
            replay = None
            if args.replay_init:
                replay = dict(np.load(os.path.join(args.replay_init,
                                                   CLI_INIT_DRAWS.format(scene, seed))))
            head = {"package": "port", "scene": scene,
                    "init_draws": "reference" if replay else "own"}
            try:
                r, _ = cli_test_run(cli, tracker, seq, ts, gt, seed, replay, device=args.device)
            except ReplayDiverged as exc:
                stopped += 1
                r = {"seed": seed, "stopped": str(exc)}
            print(json.dumps({**head, **r}), flush=True)
    return 1 if stopped else 0


def summarize(specs: list, early: int) -> int:
    """--summarize: the spreads of groups of logged runs (see the module
    docstring)."""
    import itertools

    from scipy.stats import mannwhitneyu

    groups = {}
    for spec in specs:
        name, files = spec.split("=", 1)
        runs, stopped = {}, []
        for path in files.split(","):
            for line in open(path):
                if not line.startswith("{"):
                    continue
                r = json.loads(line)
                if "stopped" in r:
                    stopped.append(r["seed"])
                elif "seed" in r and "ate_m" in r:
                    runs[(r.get("scene"), r["seed"])] = r
                elif "by_seed" in r.get("interactive", {}):
                    for seed, v in r["interactive"]["by_seed"].items():
                        runs[(None, int(seed))] = {**v, "seed": int(seed)}
        groups[name] = runs
        a = np.array([r["ate_m"] for r in runs.values()])
        first = [r["ate_m"] for r in runs.values() if (r.get("init_frame") or 99) <= early]
        late = [r["ate_m"] for r in runs.values() if (r.get("init_frame") or 99) > early]
        print(json.dumps({
            "group": name, "runs": len(a), "stopped": stopped,
            "median_ate_m": float(np.median(a)), "max_ate_m": float(a.max()),
            "init_early": len(first), "init_early_median_m": float(np.median(first)) if first else None,
            "init_later": len(late), "init_later_median_m": float(np.median(late)) if late else None,
            "by_run": {f"{k[0]}/{k[1]}" if k[0] is not None else str(k[1]):
                       [r.get("init_frame"), round(r["ate_m"], 4)]
                       for k, r in sorted(runs.items())}}))
    for (n1, g1), (n2, g2) in itertools.combinations(groups.items(), 2):
        same = [k for k in g1 if k in g2 and g1[k].get("init_frame") == g2[k].get("init_frame")]
        a, b = [g1[k]["ate_m"] for k in same], [g2[k]["ate_m"] for k in same]
        print(json.dumps({
            "pair": [n1, n2], "mann_whitney_p": float(mannwhitneyu(
                [r["ate_m"] for r in g1.values()], [r["ate_m"] for r in g2.values()]).pvalue),
            "same_init_frame": len(same),
            "same_init_medians_m": [float(np.median(a)), float(np.median(b))] if same else None,
            "first_worse": sum(x > y for x, y in zip(a, b))}))
        for cls, cmp in compare_extents(g1, g2).items():
            print(json.dumps({"pair": [n1, n2], "cls": cls, **cmp}))
    return 0


def compare_extents(g1: dict, g2: dict) -> dict:
    """Per object class of the runs' ``object_extents`` (line or EAO mode):
    the objects in each group, the medians of their member points and of
    their extents per axis (map units), and the two-sided Mann-Whitney p of
    each."""
    from scipy.stats import mannwhitneyu

    def by_cls(g):
        out = {}
        for r in g.values():
            for o in r.get("object_extents", []):
                out.setdefault(o["cls"], []).append(o)
        return out

    c1, c2 = by_cls(g1), by_cls(g2)
    out = {}
    for cls in sorted(set(c1) & set(c2)):
        row = {"objects": [len(c1[cls]), len(c2[cls])]}
        for key, axes in (("members", (None,)), ("extent", (0, 1, 2))):
            for ax in axes:
                a, b = ([o[key] if ax is None else o[key][ax] for o in c[cls]] for c in (c1, c2))
                name = key if ax is None else f"{key}_{'xyz'[ax]}"
                row[name] = {"medians": [float(np.median(a)), float(np.median(b))],
                             "p": float(mannwhitneyu(a, b).pvalue)}
        out[cls] = row
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seeds", type=int, nargs="+", default=list(chip_smoke.SEEDS))
    p.add_argument("--flag", choices=("None", "EAO", "LineAndiForest"), default="None")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--interactive", action="store_true",
                   help="the interactive per-frame tracker, System(chunked=False)")
    p.add_argument("--replay-init", metavar="DIR",
                   help="--interactive or --cli-test: the reference's init draws from DIR")
    p.add_argument("--cli-test", metavar="DIR",
                   help="run_mono_tum on tests/test_cli.py's sequence, written under DIR")
    p.add_argument("--scenes", type=int, nargs="+", default=[4],
                   help="--cli-test: the scene seeds")
    p.add_argument("--summarize", nargs="+", metavar="NAME=LOG[,LOG...]",
                   help="the spreads and Mann-Whitney p of logged runs, by group")
    p.add_argument("--early", type=int, default=5,
                   help="--summarize: the last init frame counted as early")
    p.add_argument("--ref-ba-rounding", action="store_true",
                   help="--interactive: the BA's terms rounded as the reference's one-hot "
                        "matmuls round them (ref_rounding_lm_system)")
    p.add_argument("--record-yaw", metavar="DIR",
                   help="line mode: write every yaw call of each run to DIR")
    args = p.parse_args()
    if args.summarize:
        return summarize(args.summarize, args.early)
    if args.replay_init and not (args.interactive or args.cli_test):
        p.error("--replay-init needs --interactive or --cli-test")
    if args.ref_ba_rounding and not args.interactive:
        p.error("--ref-ba-rounding needs --interactive")
    if args.record_yaw and args.flag != "LineAndiForest":
        p.error("--record-yaw needs --flag LineAndiForest")
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("port_ate_spread: no CUDA device is available", file=sys.stderr)
        return 1
    if args.cli_test:
        return cli_test(args)
    ts, gt, images = chip_smoke.render_sequence()
    print(chip_smoke.card_line() if args.device == "cuda" else "device: cpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    boxes = chip_smoke.bench_boxes(gt) if args.flag != "None" else None
    runs, stopped = [], []
    for seed in args.seeds:
        if args.interactive:
            from eao_slam_torch.runtime import tracker
            from eao_slam_torch.system import System

            sysm = System(chip_smoke.main_config(seed, boxes is not None, args.flag),
                          chunked=False, device=args.device)
            replay = None
            if args.replay_init:
                replay = dict(np.load(os.path.join(args.replay_init, INIT_DRAWS.format(seed))))
            head = {"seed": seed, "flag": args.flag, "interactive": True,
                    "init_draws": "reference" if replay else "own",
                    "ba_rounding": "reference" if args.ref_ba_rounding else "port"}
            try:
                with InitAttempts(tracker, replay) as attempts, \
                        ref_ba_rounding(args.ref_ba_rounding):
                    r = {**head, **drive_recorded(sysm, ts, gt, images, boxes, attempts)}
            except ReplayDiverged as exc:
                stopped.append(seed)
                print(json.dumps({**head, "stopped": str(exc)}), flush=True)
                continue
            runs.append(r)
            print(json.dumps(r), flush=True)
            continue
        with contextlib.ExitStack() as stack:
            calls = stack.enter_context(YawCalls()) if args.record_yaw else None
            r = chip_smoke.run_main_path(ts, gt, images, seed, boxes=boxes, device=args.device,
                                         flag=None if args.flag == "None" else args.flag)
        if calls is not None:
            os.makedirs(args.record_yaw, exist_ok=True)
            r["yaw_calls"] = os.path.join(args.record_yaw, f"yaw_calls_seed{seed}.npz")
            calls.save(r["yaw_calls"])
        for key in ("timer", "poses", "frame_trajectory"):
            r.pop(key)
        runs.append(r)
        print(json.dumps(r), flush=True)
    if not runs:
        return 1
    ates = [r["ate_m"] for r in runs]
    summary = {"flag": args.flag, "device": args.device, "median_ate_m": float(np.median(ates)),
               "max_ate_m": float(np.max(ates)), "seeds": args.seeds,
               "min_tracked_share": min(r["tracked"] / r["total"] for r in runs)}
    if boxes is not None:
        summary["min_objects"] = min(r["objects"] for r in runs)
        summary["max_object_centre_err_m"] = max(max(r["object_centre_err_m"]) for r in runs)
        summary["max_supported_yaw_err_deg"] = max(
            [abs(o["yaw_deg"]) for r in runs for o in r.get("object_yaws", [])
             if o["votes"] >= 3], default=None)
    if stopped:
        summary["stopped_seeds"] = stopped
    print(json.dumps(summary))
    return 1 if stopped else 0


if __name__ == "__main__":
    sys.exit(main())
