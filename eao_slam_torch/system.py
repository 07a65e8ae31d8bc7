"""System facade for chunked tracking, in geometry mode or with the EAO
object layer (``flag=DemoFlag.EAO`` or another object-layer flag).

``System(cfg).track_monocular(img, t, boxes=...)`` bootstraps two-view
initialization frame by frame, then buffers raw images (and their offline
detector boxes) into chunks and dispatches each full chunk through ORB
extraction and chunk tracking. ``track_frame(frame, t)`` is the same with
pre-extracted front-end output (the feature-level seam; boxes ride on the
Frame). After every chunk the tracker runs its between-chunk passes:
object merge, map maintenance, loop closing and relocalization.
Poses come back at chunk granularity; ``flush()`` dispatches a partial
tail chunk, ``frame_trajectory()`` returns every tracked pose and
``current_pose()`` the newest one, extrapolated over the buffered frames.
``set_groundtruth`` arms the GT-pose protocol of a TUM sequence: the
initializer frame's ground-truth pose rotates the initial map onto the
ground. ``save_keyframe_trajectory_tum``, ``save_frame_trajectory_tum`` and
``save_objects_json`` export a run; ``timing_stats`` summarises the time
per ``track_monocular`` call. ``save_checkpoint`` / ``load_checkpoint``
stop and resume a run.

Runs on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import json
import time
from typing import Optional

import numpy as np
import torch

from eao_slam_torch.config import DemoFlag, SystemConfig, check_supported, tum3_config
from eao_slam_torch.geometry import se3
from eao_slam_torch.io.trajectory import save_tum
from eao_slam_torch.io.tum import GroundTruth, load_groundtruth, lookup_pose_matrix
from eao_slam_torch.runtime.frame import Frame, empty_boxes, frame_from_image
from eao_slam_torch.runtime.scan_tracker import ChunkedTracker, batch_from_frames

OK = 2


class System:
    """Monocular object SLAM engine (System::System + TrackMonocular)."""

    def __init__(self, config: Optional[SystemConfig] = None,
                 flag: DemoFlag | str = DemoFlag.NONE, chunked: bool = True,
                 chunk: int = 32, device=None):
        self.cfg = config if config is not None else tum3_config(flag)
        check_supported(self.cfg, chunked=chunked)
        self.tracker = ChunkedTracker(self.cfg, chunk=chunk, device=device)
        self.tracker.compaction_listeners.append(self._on_compaction)
        self.device = self.tracker.device
        # retained keyframe images, keyed by keyframe slot and remapped
        # through compactions; only the offline semi-dense phase (ROADMAP.md
        # Queue 1 item 12) fills it
        self._kf_images: dict = {}
        # chunk buffers (image path and feature path: one per System)
        self._img_buf: list = []     # (img u8, ts, boxes or None)
        self._frame_buf: list = []   # (Frame, ts)
        self._groundtruth: Optional[GroundTruth] = None
        self.timings: list = []      # seconds per track_monocular call

    @property
    def _armed(self) -> bool:
        return self.tracker.carry is not None

    def track_monocular(self, img, timestamp: float, boxes=None) -> Optional[np.ndarray]:
        """Feed one grayscale image [H, W] and, with the object layer, its
        detector boxes: (boxes [B, 4] x y w h, class [B], score [B], valid
        [B]) in the offline-detector contract (``io.tum.load_yolo_boxes``).
        Returns T_cw [3, 4] when a pose is known at this call (bootstrap, or
        the last frame of a chunk just dispatched), else None."""
        t0 = time.perf_counter()
        T = None
        if self._armed:
            if self._frame_buf:
                raise RuntimeError("mixed track_frame / track_monocular")
            self._img_buf.append((np.asarray(img, np.uint8), float(timestamp), boxes))
            if len(self._img_buf) >= self.tracker.chunk:
                T = self._flush_images()
        else:
            T = self.track_frame(frame_from_image(self.cfg, img, self.device, boxes=boxes),
                                 timestamp)
        self.timings.append(time.perf_counter() - t0)
        return T

    def set_groundtruth(self, gt_or_path) -> None:
        """Arm the GT-pose protocol (src/Tracking.cc:197-241): a
        ``GroundTruth`` or the path of a TUM ground-truth file. Each frame
        fed before the tracker is armed looks up its pose by timestamp; the
        initializer frame's rotates the initial map onto the ground."""
        if isinstance(gt_or_path, str):
            gt_or_path = load_groundtruth(gt_or_path)
        if not isinstance(gt_or_path, GroundTruth):
            raise TypeError(f"expected a GroundTruth or a path, got {type(gt_or_path)}")
        self._groundtruth = gt_or_path

    def track_frame(self, frame: Frame, timestamp: float) -> Optional[np.ndarray]:
        """Feed a pre-extracted Frame (``runtime.frame.frame_from_arrays``).
        Returns T_cw [3, 4] as ``track_monocular`` does."""
        frame = Frame(*(None if x is None else x.to(self.device) for x in frame))
        if self._armed:
            if self._img_buf:
                raise RuntimeError("mixed track_frame / track_monocular")
            self._frame_buf.append((frame, float(timestamp)))
            if len(self._frame_buf) >= self.tracker.chunk:
                return self._flush_frames()
            return None
        gt_pose = None
        if self._groundtruth is not None:
            gt_pose = lookup_pose_matrix(self._groundtruth, timestamp)
        inner = self.tracker.inner
        self.tracker.bootstrap(frame, float(timestamp), gt_pose=gt_pose)
        return np.asarray(inner.last_T) if inner.state == OK else None

    def _flush_images(self) -> Optional[np.ndarray]:
        buf, self._img_buf = self._img_buf, []
        if not buf:
            return None
        imgs = np.stack([b[0] for b in buf])
        ts = np.asarray([b[1] for b in buf], np.float32)
        kw = {}
        if self.cfg.flag.objects_enabled:
            bx = [empty_boxes(self.cfg) if b[2] is None else b[2] for b in buf]
            kw = {k: np.stack([np.asarray(b[i]) for b in bx]) for i, k in
                  enumerate(("boxes", "box_class", "box_score", "box_valid"))}
        outs = self.tracker.track_images(imgs, ts, **kw)
        n = len(buf)
        return np.asarray(outs.T[n - 1]) if int(outs.state[n - 1]) == OK else None

    def _flush_frames(self) -> Optional[np.ndarray]:
        """Dispatch the buffered frames as one chunk, a short tail padded
        with its last frame and masked inactive."""
        buf, self._frame_buf = self._frame_buf, []
        if not buf:
            return None
        C = self.tracker.chunk
        n = len(buf)
        frames = [b[0] for b in buf] + [buf[-1][0]] * (C - n)
        ts = [b[1] for b in buf] + [buf[-1][1]] * (C - n)
        batch = batch_from_frames(frames, ts)
        if n < C:
            act = np.zeros((C,), bool)
            act[:n] = True
            batch = batch._replace(active=torch.as_tensor(act))
        outs = self.tracker.track_batch(batch)
        return np.asarray(outs.T[n - 1]) if int(outs.state[n - 1]) == OK else None

    def _on_compaction(self, kf_remap: np.ndarray, pt_remap: np.ndarray):
        """Keyframe slots were compacted: re-key the retained images."""
        self._kf_images = {int(kf_remap[s]): img for s, img in self._kf_images.items()
                           if 0 <= s < len(kf_remap) and kf_remap[s] >= 0}

    def flush(self) -> None:
        """Dispatch any partially filled chunk."""
        if self._img_buf:
            self._flush_images()
        if self._frame_buf:
            self._flush_frames()

    def current_pose(self, extrapolate: bool = True):
        """The newest pose estimate without waiting for a chunk boundary:
        (timestamp, T_cw [3, 4]) of the newest tracked frame or, with
        ``extrapolate`` and frames still buffered while tracking is OK, that
        pose carried through the motion model once per buffered frame (the
        prediction the next chunk starts from) with the newest buffered
        timestamp. None before initialization."""
        tr = self.tracker
        t_last = T_last = None
        for t, T, _ in reversed(tr.records):
            if T is not None:
                t_last, T_last = t, T
                break
        if T_last is None:
            return None
        n_buf = len(self._img_buf) + len(self._frame_buf)
        if not extrapolate or n_buf == 0 or not tr.armed or tr.state != OK:
            return t_last, np.asarray(T_last)
        vel, T = tr.carry.velocity, tr.carry.T_last
        for _ in range(n_buf):
            T = se3.compose(vel, T)
        buf = self._img_buf or self._frame_buf
        return float(buf[-1][1]), T.cpu().numpy()

    def timing_stats(self) -> dict:
        """Median and mean seconds per ``track_monocular`` call, and the
        rate the mean gives (mono_tum's end-of-run summary); {} before the
        first call."""
        if not self.timings:
            return {}
        t = np.asarray(self.timings)
        return {"median_s": float(np.median(t)), "mean_s": float(t.mean()),
                "fps": float(1.0 / max(t.mean(), 1e-9))}

    def save_keyframe_trajectory_tum(self, path: str) -> int:
        """The keyframe trajectory as a TUM file; returns its rows."""
        ts, Ts = self.keyframe_trajectory()
        return save_tum(path, ts, Ts)

    def save_frame_trajectory_tum(self, path: str) -> int:
        """Every tracked frame's pose as a TUM file; returns its rows."""
        ts, Ts = self.frame_trajectory()
        return save_tum(path, ts, Ts)

    def save_objects_json(self, path: str) -> int:
        """The live object landmarks (valid, not bad) as a JSON list of
        {id, class, center, size, yaw, n_obs}; an empty list in geometry
        mode. Returns the number written."""
        self.flush()
        t = self.tracker.obj_table
        out = []
        if t is not None:
            tab = {k: v.cpu().numpy() for k, v in t._asdict().items()}
            for j in np.flatnonzero(tab["valid"] & ~tab["bad"]):
                out.append({"id": int(j), "class": int(tab["cls"][j]),
                            "center": tab["center"][j].tolist(),
                            "size": (tab["cub_max"][j] - tab["cub_min"][j]).tolist(),
                            "yaw": float(tab["yaw"][j]), "n_obs": int(tab["n_obs"][j])})
        with open(path, "w") as f:
            json.dump(out, f, indent=1)
        return len(out)

    def save_checkpoint(self, path: str) -> None:
        """Serialize the tracker mid-sequence (pending buffers flush first):
        carry, trajectory records, loop-closer state, loop RNG."""
        from eao_slam_torch.runtime.checkpoint import save_chunked_checkpoint

        self.flush()
        save_chunked_checkpoint(path, self.tracker)

    def load_checkpoint(self, path: str) -> dict:
        """Restore a checkpoint into this System (same capacities); tracking
        resumes where the save left off. Returns the file's meta dict."""
        from eao_slam_torch.runtime.checkpoint import load_chunked_checkpoint

        meta = load_chunked_checkpoint(path, self.tracker)
        self._img_buf = []
        self._frame_buf = []
        return meta

    def shutdown(self, semidense: bool = False):
        """Flush the tail chunk. The offline semi-dense phase is ROADMAP.md
        Queue 1 item 12."""
        if semidense:
            raise NotImplementedError(
                "the offline semi-dense phase is not ported yet: ROADMAP.md "
                "Queue 1 item 12")
        self.flush()

    def frame_trajectory(self):
        """(timestamps [N], T_cw [N, 3, 4]) of every tracked frame."""
        self.flush()
        return self.tracker.frame_trajectory()

    def keyframe_trajectory(self):
        self.flush()
        return self.tracker.keyframe_trajectory()

