"""One run of one cell: set-up, the measured window, the traced stretch
(``trace``), the comparison that decides ``correct``, and the result line.
"""

from __future__ import annotations

import gc
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

from harness import check, faults, inputs as inputs_mod, trace as trace_mod
from harness.program import Capture, Drive, port_config
from harness.spans import Spans
from harness.trajectory import aligned_error_share, map_object_errors, relative_motion_errors

TRACED_LIVE_FRAMES = 16       # frames the profiler traces after a live window
LIVE_FRONTEND_SAMPLE = 32     # window frames of the live mode the reference re-extracts
MOTION_STEP = 4               # frames between the two poses of a compared motion
OBJECT_SHOWN = 16             # frames with a box of an object before it must be found


def card() -> dict:
    """The card's name, power limit and SM clock, from nvidia-smi."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout
    name, power, clock = [x.strip() for x in out.splitlines()[0].split(",")]
    return {"name": name, "power_limit_w": float(power), "sm_clock_hz": float(clock) * 1e6}


def _finite(x):
    return x if x is None or math.isfinite(x) else None


def _as_program(ref: list, scale_factor: float) -> dict:
    """The reference's per-level output laid out as the program's features."""
    out = {"kp": [], "desc": [], "octave": [], "valid": []}
    for l, r in enumerate(ref):
        yx = r["yx"]
        out["kp"].append(np.stack([yx[..., 1], yx[..., 0]], -1).astype(np.float32)
                         * np.float32(scale_factor ** l))
        out["desc"].append(r["desc"])
        out["octave"].append(np.full(r["valid"].shape, l, np.int32))
        out["valid"].append(r["valid"])
    return {k: np.concatenate(v, 1) for k, v in out.items()}


def frontend_numbers(drive: Drive, capture: Capture, seed: int, device, control: bool = False):
    """The sampled window frames through the plain reference, against what
    the program's front end made of them; with ``control``, against the
    reference computed in TF32 in the program's place."""
    from reference import orb as ref_orb

    cfg = drive.cfg
    lo, n, _ = drive.window
    if not capture.outputs:
        return 1.0, 1.0         # the front end gave nothing for the window's frames
    rng = np.random.default_rng(seed)
    if drive.mode == "chunked":
        k = int(rng.integers(len(capture.outputs)))
        groups = [(capture.host(k, True), slice(lo + k * drive.chunk, lo + (k + 1) * drive.chunk))]
    else:
        pick = np.sort(rng.choice(n, size=min(n, LIVE_FRONTEND_SAMPLE), replace=False))
        groups = [(capture.host(int(j), False), [lo + int(j)]) for j in pick]
    o = cfg.orb
    agg = {"kp": [], "desc": [], "octave": [], "valid": []}
    refs = []
    for prog, idx in groups:
        imgs = torch.as_tensor(drive.inputs.images[idx], device=device)
        args = (imgs, cfg.capacity.max_features, o.n_levels, o.scale_factor,
                float(o.fast_threshold), float(o.fast_min_threshold), o.edge_threshold)
        refs.append(ref_orb.extract(*args))
        if control:
            prog = _as_program(ref_orb.extract(*args, tf32=True), o.scale_factor)
        for key in agg:
            agg[key].append(prog[key])
    prog = {k: np.concatenate(v) for k, v in agg.items()}
    ref = [{k: np.concatenate([r[l][k] for r in refs]) for k in ("yx", "valid", "desc")}
           for l in range(len(refs[0]))]
    return check.frontend_diff(prog, ref, o.scale_factor)


def trajectory_numbers(drive: Drive) -> dict:
    """The window's share of frames with no pose, and the errors of the
    camera's motion over MOTION_STEP frames against the truth
    (``relative_motion_errors``), in degrees, the mean over the window's
    pairs of tracked frames: of its rotation, and of its translation's
    direction; and the window's path against the truth once aligned
    (``aligned_error_share``)."""
    T = drive.window_poses()
    lo, n, _ = drive.window
    ok = np.isfinite(T).all(axis=(1, 2))
    rot, dirn = relative_motion_errors(T, drive.inputs.gt[lo:lo + n], MOTION_STEP)
    good = np.isfinite(rot)
    return {"untracked_share": 1.0 - ok.mean(),
            "motion_rot_err_deg": float(rot[good].mean()) if good.any() else float("inf"),
            "motion_dir_err_deg": float(dirn[good].mean()) if good.any() else float("inf"),
            "trajectory_err_share": aligned_error_share(T, drive.inputs.gt[lo:lo + n])}


def object_numbers(drive: Drive) -> dict:
    """Of the scene objects that the boxes showed in at least OBJECT_SHOWN
    of the frames fed: how many have no live object of their class seen
    from a keyframe, and the worst centre error of the others
    (``map_object_errors``)."""
    tr = drive.system.tracker
    scene = drive.inputs.scene
    tab = {k: v.cpu().numpy() for k, v in tr.obj_table._asdict().items()}
    m = {k: v.cpu().numpy() for k, v in tr.map._asdict().items()}
    fed = drive.n_fed
    errs = map_object_errors(m, tab, np.arange(fed) / drive.fps, drive.inputs.gt[:fed],
                             scene.obj_centers, scene.obj_classes)
    boxes, cls, _, valid = drive.inputs.boxes
    shown = [int(((cls[:fed] == c) & valid[:fed]).any(1).sum()) >= OBJECT_SHOWN
             for c in scene.obj_classes]
    errs = [e for e, s in zip(errs, shown) if s]
    found = [e for e in errs if math.isfinite(e)]
    return {"objects_missing": float(len(errs) - len(found)),
            "object_err_m": max(found) if found else float("inf")}


def program_tf32() -> None:
    """Let the program's float32 matrix products run in TF32: every
    ``fp32_solvers`` the port calls (it pins TF32 off before each chunk and
    solve) turns it on instead."""
    import eao_slam_torch.system  # noqa: F401  (loads every module that pins it)

    def tf32_solvers():
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True

    for mod in list(sys.modules.values()):
        if getattr(mod, "__name__", "").startswith("eao_slam_torch") and hasattr(mod, "fp32_solvers"):
            mod.fp32_solvers = tf32_solvers
    tf32_solvers()


def run_cell(spec, cell_name: str, seed: int, seconds: float, trace: bool,
             t_start: float, device=None, patch=None, control: str = None) -> tuple:
    """Run one cell once. Returns (result dict, check lines).

    ``device`` None runs on the card. ``patch(drive)`` is called before
    set-up, under the benchmark's own wrappers (tests plant faults with it).
    ``control`` "tf32" runs the control (the program's matrix products in
    TF32, and for the front end's numbers the reference computed in TF32 in
    the program's place); the name of a fault of ``harness.faults`` plants
    that fault."""
    cell = spec.cell(cell_name)
    traffic = cell.traffic
    cfg = port_config(cell.config, seed)
    with_boxes = bool(traffic.get("boxes")) and cfg.flag.objects_enabled
    data = inputs_mod.load(cell.config, cfg.capacity.max_boxes if with_boxes else 0,
                           cache_dir=os.path.join(spec.bench_dir, "cache"))
    if device is None:
        from eao_slam_torch.ops import fast_nms

        fast_nms.build()
    if control == "tf32":
        program_tf32()
    elif control is not None:
        patch = lambda d: faults.FAULTS[control](d, setattr)  # noqa: E731
    drive = Drive(cfg, traffic, data, device=device)
    dev = drive.device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    if patch is not None:
        patch(drive)
    import eao_slam_torch.runtime.scan_tracker as st
    import eao_slam_torch.system as sm_mod

    capture = (Capture(st, "extract_batch") if drive.mode == "chunked"
               else Capture(sm_mod, "frame_from_image"))
    spans = (Spans(spec.spans([e["name"] for e in cell.per_layer]), drive.system, dev)
             if trace else None)
    # the traced stretch: one whole chunk, or a few frames of the live mode
    traced = drive.chunk if drive.mode == "chunked" else TRACED_LIVE_FRAMES
    try:
        drive.setup()
        setup_s = time.perf_counter() - t_start
        capture.on = True
        if spans is not None:
            spans.recording = True
        drive.run_window(drive.window_frames(seconds))
        capture.on = False
        profile = None
        if spans is not None:
            spans.recording = False
            if dev.type == "cuda":
                spans.annotate = True
                profile = trace_mod.profile(lambda: drive.more(traced), dev)
                spans.annotate = False
    finally:
        capture.close()
        if spans is not None:
            spans.close()
    mem_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    lo, n_window, window_s = drive.window

    numbers = trajectory_numbers(drive)
    if cfg.flag.objects_enabled:
        numbers.update(object_numbers(drive))
    attempted = n_window
    failed = int(round(numbers["untracked_share"] * n_window))
    calls = np.asarray(drive.call_s)
    # free the program's state before the reference runs, so it sets no peak
    system = drive.system
    drive.system = None
    del system
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    kp_diff, desc_diff = frontend_numbers(drive, capture, seed, dev,
                                          control=control == "tf32")
    numbers["frontend_kp_diff"] = kp_diff
    numbers["frontend_desc_diff"] = desc_diff
    correct, checks = check.judge(numbers, cell.limits)

    e2e = {"fps": n_window / window_s, "setup_s": setup_s}
    if len(calls):
        e2e["frame_ms_p95"] = float(np.percentile(calls, 95) * 1e3)
    result = {"correct": correct, "attempted": attempted, "failed": failed}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(mem_peak)}
    if not trace:
        result["metrics"] = {e["name"]: {"value": e2e[e["name"]], "unit": e["unit"]}
                             for e in cell.end_to_end if e["name"] in e2e}
    else:
        rec = {"mode": drive.mode, "config": cell.config, "traffic": traffic,
               "window": {"frames": n_window, "seconds": window_s},
               "spans": spans.times, "profile": profile,
               "traced_frames": traced,
               "device": card() if dev.type == "cuda" else {}}
        metrics = {}
        for e in cell.per_layer:
            v = spec.metric(e["name"]).read(rec)
            if v is not None:
                metrics[e["name"]] = {"value": v, "unit": e["unit"]}
        result["metrics"] = metrics
        if profile is not None:
            device_info["busy_s"] = profile["busy_s"]
            device_info["window_s"] = profile["wall_s"]
            top = sorted(profile["ops"].items(), key=lambda kv: -kv[1]["device_s"])[:10]
            result["breakdown"] = {"device_ops": [[k, v["device_s"]] for k, v in top],
                                   "idle_gaps": profile["idle_gaps"]}
    result["device"] = device_info
    result["work"] = {"first_frame": lo, "frames": n_window, "keyframes": drive.keyframes}
    result["checks"] = {k: {"value": _finite(v["value"]), "limit": v["limit"]}
                        for k, v in checks.items()}
    lines = [f"check {k}: {v['value']} (limit {v['limit']})" for k, v in checks.items()]
    return result, lines
