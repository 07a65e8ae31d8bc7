"""System facade for geometry-mode chunked tracking.

``System(cfg).track_monocular(img, t)`` bootstraps two-view initialization
frame by frame, then buffers raw images into chunks and dispatches each
full chunk through ORB extraction and chunk tracking. Poses come back at
chunk granularity; ``flush()`` dispatches a partial tail chunk and
``frame_trajectory()`` returns every tracked pose.

Runs on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from eao_slam_torch.config import DemoFlag, SystemConfig, check_supported, tum3_config
from eao_slam_torch.runtime.frame import frame_from_image
from eao_slam_torch.runtime.scan_tracker import ChunkedTracker

OK = 2


class System:
    """Monocular SLAM engine (System::System + TrackMonocular), geometry mode."""

    def __init__(self, config: Optional[SystemConfig] = None,
                 flag: DemoFlag | str = DemoFlag.NONE, chunked: bool = True,
                 chunk: int = 32, device=None):
        self.cfg = config if config is not None else tum3_config(flag)
        check_supported(self.cfg, chunked=chunked)
        self.tracker = ChunkedTracker(self.cfg, chunk=chunk, device=device)
        self.device = self.tracker.device
        self._img_buf: list = []   # (img u8, ts)

    @property
    def _armed(self) -> bool:
        return self.tracker.carry is not None

    def track_monocular(self, img, timestamp: float) -> Optional[np.ndarray]:
        """Feed one grayscale image [H, W]. Returns T_cw [3, 4] when a pose
        is known at this call (bootstrap, or the last frame of a chunk just
        dispatched), else None."""
        T = None
        if self._armed:
            self._img_buf.append((np.asarray(img, np.uint8), float(timestamp)))
            if len(self._img_buf) >= self.tracker.chunk:
                T = self._flush_images()
        else:
            frame = frame_from_image(self.cfg, img, self.device)
            inner = self.tracker.inner
            self.tracker.bootstrap(frame, float(timestamp))
            if inner.state == OK:
                T = np.asarray(inner.last_T)
        return T

    def _flush_images(self) -> Optional[np.ndarray]:
        buf, self._img_buf = self._img_buf, []
        if not buf:
            return None
        imgs = np.stack([b[0] for b in buf])
        ts = np.asarray([b[1] for b in buf], np.float32)
        outs = self.tracker.track_images(imgs, ts)
        n = len(buf)
        return np.asarray(outs.T[n - 1]) if int(outs.state[n - 1]) == OK else None

    def flush(self) -> None:
        """Dispatch any partially filled chunk."""
        if self._img_buf:
            self._flush_images()

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
