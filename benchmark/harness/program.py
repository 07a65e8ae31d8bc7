"""The system under test, driven the way its users drive it: the port's
configuration built from a configuration file, ``System.track_monocular``
fed the cell's frames in the trajectory's order, each once, and the front
end's output of the window captured for the comparison (references to the
tensors the program made, no copy).

The window is a fixed amount of work: the ``seconds x window_fps`` frames
(``window_fps`` from the traffic file) that follow set-up, so that every
run of a cell times the same frames of the same trajectory from the same
point, and the rate is that work over the time it took.

``chunked``: the offline user's path. Bootstrap frame by frame until the
map exists, one warm-up chunk, then the window in whole chunks; a chunk's
poses come back when it is dispatched.
``live``: the interactive user's path (``System(chunked=False)``), a
closed loop with one client: the next frame goes in when the last pose
has come back; bootstrap, the frames up to ``start_frame``, then the
window.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

OK = 2


def port_config(config: dict, seed: int):
    """The port's SystemConfig from a configuration file: ``camera`` and
    ``flag`` by value, every other section the port's dataclass of that name
    (``orb``, ``capacity``, ``tracking``, ...) with the file's fields."""
    from eao_slam_torch import config as pc
    from eao_slam_torch.geometry.camera import Camera

    sections = {f.name: f.type for f in dataclasses.fields(pc.SystemConfig)}
    kw = {"camera": Camera(**{k: config["camera"][k] for k in Camera._fields
                              if k in config["camera"]}),
          "flag": pc.DemoFlag(config["flag"]), "seed": int(seed)}
    for name, fields in config.get("port", {}).items():
        if name not in sections:
            raise KeyError(f"the port's SystemConfig has no section {name!r}")
        kw[name] = getattr(pc, sections[name])(**fields)
    return pc.SystemConfig(**kw)


class Capture:
    """Holds the front end's output of every call of ``module.name`` while
    ``on``: the chunk's FrameBatch (chunked) or the frame's Frame (live)."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.original = getattr(module, name)
        self.outputs = []
        self.on = False

        def capture(*args, **kw):
            out = self.original(*args, **kw)
            if self.on:
                self.outputs.append((out.kp, out.desc, out.octave, out.valid))
            return out

        setattr(module, name, capture)

    def close(self):
        setattr(self.module, self.name, self.original)

    def host(self, i: int, batched: bool) -> dict:
        kp, desc, octave, valid = (x.cpu().numpy() for x in self.outputs[i])
        if not batched:
            kp, desc, octave, valid = kp[None], desc[None], octave[None], valid[None]
        return {"kp": kp, "desc": desc, "octave": octave, "valid": valid}


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Drive:
    """One run of the program over a cell's inputs."""

    def __init__(self, cfg, traffic: dict, inputs, device=None):
        from eao_slam_torch.system import System

        self.cfg = cfg
        self.traffic = traffic
        self.inputs = inputs
        self.mode = traffic["mode"]
        self.chunk = int(traffic.get("chunk", 1))
        self.fps = inputs.fps
        if self.mode == "chunked":
            self.system = System(cfg, chunk=self.chunk, device=device)
        elif self.mode == "live":
            self.system = System(cfg, chunked=False, device=device)
        else:
            raise ValueError(f"unknown traffic mode {self.mode!r}")
        self.device = self.system.device
        self.n_fed = 0          # frames fed: the next frame's index into the trajectory
        self.poses = []         # live: the pose each call returned (or None)
        self.call_s = []        # live: seconds of each call of the window
        self.window = None      # (first fed frame, frames, seconds)
        self.keyframes = 0      # keyframes the window made

    def _feed(self) -> None:
        i = self.n_fed
        if i >= len(self.inputs.images):
            raise RuntimeError(f"the trajectory has {len(self.inputs.images)} frames: "
                               "too few for this window")
        self.n_fed += 1
        b = self.inputs.boxes
        boxes = None if b is None else tuple(x[i] for x in b)
        T = self.system.track_monocular(self.inputs.images[i], i / self.fps, boxes=boxes)
        if self.mode == "live":
            self.poses.append(T)

    def _armed(self) -> bool:
        tr = self.system.tracker
        return tr.armed if self.mode == "chunked" else tr.state == OK

    def window_frames(self, seconds: float) -> int:
        """The window's frames: ``seconds x window_fps``, whole chunks."""
        n = math.ceil(seconds * float(self.traffic["window_fps"]) / self.chunk)
        return max(n, 1) * self.chunk

    def setup(self, max_bootstrap: int = 64) -> None:
        """Bootstrap and warm up (set-up time)."""
        while not self._armed():
            if self.n_fed >= max_bootstrap:
                raise RuntimeError(f"two-view initialization failed in {max_bootstrap} frames")
            self._feed()
        end = (self.n_fed + self.chunk if self.mode == "chunked"
               else max(self.n_fed, int(self.traffic["start_frame"])))
        while self.n_fed < end:
            self._feed()
        sync(self.device)

    def _keyframe_count(self) -> int:
        tr = self.system.tracker
        return tr.kf_count_host if self.mode == "chunked" else self._live_keyframes

    def run_window(self, n_frames: int) -> None:
        """Feed the window's ``n_frames`` frames, then synchronise."""
        lo = self.n_fed
        self._live_keyframes = 0
        kf0 = self._keyframe_count()
        t0 = time.perf_counter()
        if self.mode == "chunked":
            for _ in range(n_frames):
                self._feed()
        else:
            tr = self.system.tracker
            for _ in range(n_frames):
                c0 = time.perf_counter()
                self._feed()
                self.call_s.append(time.perf_counter() - c0)
                self._live_keyframes += tr.state == OK and tr.frames_since_kf == 0
        sync(self.device)
        self.window = (lo, self.n_fed - lo, time.perf_counter() - t0)
        self.keyframes = self._keyframe_count() - kf0

    def more(self, n: int) -> None:
        """Feed ``n`` more frames (the traced stretch, after the window)."""
        for _ in range(n):
            self._feed()
        sync(self.device)

    def window_poses(self) -> np.ndarray:
        """The window's poses [n, 3, 4], NaN where a frame has none."""
        lo, n, _ = self.window
        if self.mode == "chunked":
            # every fed frame has a record: the bootstrap's one a call, then a chunk's
            recs = self.system.tracker.records[lo:lo + n]
            Ts = [r[1] for r in recs]
        else:
            Ts = self.poses[lo:lo + n]
        out = np.full((n, 3, 4), np.nan)
        for j, T in enumerate(Ts):
            if T is not None:
                out[j] = np.asarray(T, np.float64)
        return out
