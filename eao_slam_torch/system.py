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
tail chunk and ``frame_trajectory()`` returns every tracked pose.
``save_checkpoint`` / ``load_checkpoint`` stop and resume a run.

Runs on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from eao_slam_torch.config import DemoFlag, SystemConfig, check_supported, tum3_config
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

    @property
    def _armed(self) -> bool:
        return self.tracker.carry is not None

    def track_monocular(self, img, timestamp: float, boxes=None) -> Optional[np.ndarray]:
        """Feed one grayscale image [H, W] and, with the object layer, its
        detector boxes: (boxes [B, 4] x y w h, class [B], score [B], valid
        [B]) in the offline-detector contract (``io.tum.load_yolo_boxes``).
        Returns T_cw [3, 4] when a pose is known at this call (bootstrap, or
        the last frame of a chunk just dispatched), else None."""
        if self._armed:
            if self._frame_buf:
                raise RuntimeError("mixed track_frame / track_monocular")
            self._img_buf.append((np.asarray(img, np.uint8), float(timestamp), boxes))
            if len(self._img_buf) >= self.tracker.chunk:
                return self._flush_images()
            return None
        return self.track_frame(frame_from_image(self.cfg, img, self.device, boxes=boxes),
                                timestamp)

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
        inner = self.tracker.inner
        self.tracker.bootstrap(frame, float(timestamp))
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

