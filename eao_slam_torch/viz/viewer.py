"""Headless viewer: the Viewer thread (src/Viewer.cc) without a GUI.

``update()`` after each tracked frame writes a frame overlay and a map
view as PNGs to ``out_dir`` every ``every`` frames; ``finalize()`` renders
the whole final map (covisibility graph, objects, and the semi-dense cloud
and 3D lines where a FULL run made them). The tracker's state is read
from host copies, so a tracker on the card is drawn as one on the CPU.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

from eao_slam_torch.runtime.map_state import covisibility_counts
from eao_slam_torch.viz.frame_drawer import draw_frame
from eao_slam_torch.viz.map_drawer import MapRenderOptions, render_map
from eao_slam_torch.viz.raster import save_png, to_numpy


@dataclass
class ViewerOptions:
    every: int = 10                 # render stride (frames)
    follow: bool = True             # menuFollowCamera
    render: MapRenderOptions = field(default_factory=MapRenderOptions)


class HeadlessViewer:
    def __init__(self, out_dir: str, options: ViewerOptions | None = None):
        self.out = out_dir
        self.opt = options or ViewerOptions()
        os.makedirs(out_dir, exist_ok=True)
        self.n = 0
        self.written: list = []

    def update(self, tracker, frame=None, img=None, T_cw=None, n_tracked=None) -> None:
        """Per-frame hook (FrameDrawer::Update and a map snapshot)."""
        i = self.n
        self.n += 1
        if i % self.opt.every:
            return
        if img is not None and frame is not None:
            ov = draw_frame(img, frame, state=int(tracker.state), n_tracked=n_tracked)
            self.written.append(save_png(os.path.join(self.out, f"frame_{i:06d}.png"), ov))
        m = getattr(tracker, "map", None)
        if m is not None:
            mv = render_map(m, objects=getattr(tracker, "obj_table", None),
                            cur_T_cw=T_cw if (T_cw is not None and self.opt.follow) else None,
                            opt=self.opt.render)
            self.written.append(save_png(os.path.join(self.out, f"map_{i:06d}.png"), mv))

    def finalize(self, system=None, tracker=None, semidense_pts=None,
                 semidense_sigma=None, lines3d=None) -> str:
        """Render the final map view (points, graph, objects, semi-dense
        cloud ``semidense_pts`` [N, 3] with ``semidense_sigma`` [N], 3D
        lines [M, 2, 3], a System's own when it is given) to
        ``map_final.png``; returns its path."""
        if system is not None:
            tracker = system.tracker
            if lines3d is None and system._lines3d is not None:
                # the System keeps [M, 6] rows (both endpoints); the reference
                # passes them on as they are and fails on them (ROADMAP Queue 3)
                lines3d = to_numpy(system._lines3d).reshape(-1, 2, 3)
        m = getattr(tracker, "map", None)
        covis = to_numpy(covisibility_counts(m)) if m is not None else None
        path = os.path.join(self.out, "map_final.png")
        mv = render_map(m, objects=getattr(tracker, "obj_table", None), covis=covis,
                        semidense_pts=semidense_pts, semidense_sigma=semidense_sigma,
                        lines3d=lines3d, opt=self.opt.render)
        save_png(path, mv)
        self.written.append(path)
        return path
