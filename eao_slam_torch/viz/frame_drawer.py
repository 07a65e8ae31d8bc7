"""2D frame overlay (FrameDrawer::DrawFrame, src/FrameDrawer.cc).

Tracked keypoints as green circles, keypoints inside a detector box in the
box's class colour, the detector boxes with class labels, the 2D line
segments and the status bar. Returns an RGB uint8 array
(``viz.raster.save_png`` writes it).
"""

from __future__ import annotations

import numpy as np

from eao_slam_torch.viz.raster import (
    draw_circles,
    draw_points,
    draw_rects,
    draw_segments,
    draw_text,
    gray_to_rgb,
    to_numpy,
)

STATE_NAMES = {0: "WAITING FOR IMAGES", 1: "TRYING TO INITIALIZE",
               2: "SLAM MODE", 3: "TRACK LOST"}


def class_color(cls: int) -> tuple:
    """A fixed colour per class id (boxes are coloured by class)."""
    rng = np.random.default_rng(int(cls) + 7)
    c = rng.integers(40, 230, 3)
    return int(c[0]), int(c[1]), int(c[2])


def _inside(kp: np.ndarray, box: np.ndarray) -> np.ndarray:
    x, y, w, h = box
    return (kp[:, 0] >= x) & (kp[:, 0] <= x + w) & (kp[:, 1] >= y) & (kp[:, 1] <= y + h)


def draw_frame(img, frame=None, state: int = 2, tracked_mask=None,
               n_tracked: int | None = None, show_lines: bool = True) -> np.ndarray:
    """The FrameDrawer overlay of ``img`` (grayscale [H, W] of any dtype,
    or RGB uint8) with ``frame`` (a ``runtime.frame.Frame``, its tensors on
    any device; the status bar alone without one). ``tracked_mask`` [F]
    bool marks the features matched to a map point (green); the other
    valid features are drawn grey, or in their box's class colour."""
    canvas = gray_to_rgb(to_numpy(img))
    h, w = canvas.shape[:2]

    if frame is not None:
        kp = to_numpy(frame.kp)
        valid = to_numpy(frame.valid)
        if frame.boxes is not None:
            boxes, bcls, bval = (to_numpy(frame.boxes), to_numpy(frame.box_class),
                                 to_numpy(frame.box_valid))
        else:                   # geometry mode carries no boxes
            boxes, bcls, bval = np.zeros((0, 4)), np.zeros(0, int), np.zeros(0, bool)

        if show_lines and frame.lines is not None:
            lines = to_numpy(frame.lines)
            lval = to_numpy(frame.line_valid)
            if lval.any():
                draw_segments(canvas, lines[lval, :2], lines[lval, 2:], color=(200, 120, 0))

        # in-box keypoints take the box's class colour; tracked ones get circles
        color = np.zeros((len(kp), 3), np.uint8)
        color[:] = (120, 120, 120)
        for b in range(len(boxes)):
            if bval[b] and bcls[b] >= 0:
                m = _inside(kp, boxes[b]) & valid
                color[m] = class_color(int(bcls[b]))
        tm = to_numpy(tracked_mask) if tracked_mask is not None else np.zeros(len(kp), bool)
        plain = valid & ~tm
        if plain.any():
            colors = color[plain]
            pts = kp[plain]
            for col in np.unique(colors, axis=0):
                m = (colors == col).all(axis=1)
                draw_points(canvas, pts[m], color=col, radius=1)
        if tm.any():
            draw_circles(canvas, kp[valid & tm], radius=3, color=(0, 200, 0))
            draw_points(canvas, kp[valid & tm], color=(0, 200, 0), radius=1)

        for b in range(len(boxes)):
            if bval[b] and bcls[b] >= 0:
                col = class_color(int(bcls[b]))
                draw_rects(canvas, boxes[b:b + 1], color=col, thickness=1)
                draw_text(canvas, (boxes[b, 0] + 2, boxes[b, 1] + 2), f"C{int(bcls[b])}",
                          color=col)

    # status bar (FrameDrawer::DrawTextInfo)
    bar = np.zeros((12, w, 3), np.uint8)
    txt = STATE_NAMES.get(int(state), "?")
    if n_tracked is not None:
        txt += f"  MATCHES: {int(n_tracked)}"
    draw_text(bar, (4, 2), txt, color=(255, 255, 255))
    return np.concatenate([canvas, bar], axis=0)
