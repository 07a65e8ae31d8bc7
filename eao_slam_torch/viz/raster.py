"""Pure-numpy raster primitives for the headless viewer.

Every primitive is a vectorised numpy write into an RGB uint8 canvas (the
original system draws with OpenCV and OpenGL), so a render is the same
bytes on any host; PNGs are written by a stdlib-zlib encoder. Tensors are
drawn from host copies (``viz.to_numpy``).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

# ---------------------------------------------------------------------------
# canvas + points

def blank_canvas(height: int, width: int, color=(255, 255, 255)) -> np.ndarray:
    img = np.empty((height, width, 3), np.uint8)
    img[:] = np.asarray(color, np.uint8)
    return img


def _clip_mask(uv: np.ndarray, h: int, w: int) -> np.ndarray:
    return (uv[:, 0] >= 0) & (uv[:, 0] < w) & (uv[:, 1] >= 0) & (uv[:, 1] < h)


def draw_points(img: np.ndarray, uv: np.ndarray, color=(0, 0, 0),
                radius: int = 1) -> np.ndarray:
    """Stamp square points of side 2*radius-1 at uv [N,2] (x, y) in place."""
    uv = np.asarray(uv)
    if uv.size == 0:
        return img
    h, w = img.shape[:2]
    pix = np.round(uv).astype(np.int64)
    color = np.asarray(color, np.uint8)
    for dy in range(-radius + 1, radius):
        for dx in range(-radius + 1, radius):
            p = pix + np.array([dx, dy])
            m = _clip_mask(p, h, w)
            img[p[m, 1], p[m, 0]] = color
    return img


def draw_circles(img: np.ndarray, uv: np.ndarray, radius: int = 3,
                 color=(0, 0, 0)) -> np.ndarray:
    """Hollow circles (keypoint style, cv::circle parity) at uv [N,2]."""
    uv = np.asarray(uv, np.float64)
    if uv.size == 0:
        return img
    n_samp = max(8, int(2 * np.pi * radius))
    ang = np.linspace(0, 2 * np.pi, n_samp, endpoint=False)
    ring = radius * np.stack([np.cos(ang), np.sin(ang)], -1)      # [S,2]
    pts = (uv[:, None, :] + ring[None, :, :]).reshape(-1, 2)
    return draw_points(img, pts, color=color, radius=1)


# ---------------------------------------------------------------------------
# lines

def draw_segments(img: np.ndarray, p0: np.ndarray, p1: np.ndarray,
                  color=(0, 0, 0), thickness: int = 1) -> np.ndarray:
    """Rasterize line segments p0->p1 ([N,2] each, pixel coords) by dense
    sampling — one vectorized scatter per batch, no per-pixel Python."""
    p0 = np.atleast_2d(np.asarray(p0, np.float64))
    p1 = np.atleast_2d(np.asarray(p1, np.float64))
    if p0.size == 0:
        return img
    h, w = img.shape[:2]
    # cheap clip reject of segments entirely off-canvas
    lo = np.minimum(p0, p1)
    hi = np.maximum(p0, p1)
    keep = (hi[:, 0] >= 0) & (lo[:, 0] < w) & (hi[:, 1] >= 0) & (lo[:, 1] < h)
    p0, p1 = p0[keep], p1[keep]
    if len(p0) == 0:
        return img
    length = np.abs(p1 - p0).max(axis=1)
    n = int(min(max(length.max(), 1), 4 * (h + w)))  # samples per segment
    t = np.linspace(0.0, 1.0, n + 1)                             # [S]
    pts = p0[:, None, :] + (p1 - p0)[:, None, :] * t[None, :, None]
    return draw_points(img, pts.reshape(-1, 2), color=color, radius=thickness)


def draw_rects(img: np.ndarray, rects: np.ndarray, color=(255, 0, 0),
               thickness: int = 1) -> np.ndarray:
    """Axis-aligned boxes [N,4] as (x, y, w, h) — the BoxSE/YOLO contract."""
    rects = np.atleast_2d(np.asarray(rects, np.float64))
    if rects.size == 0:
        return img
    x, y, bw, bh = rects[:, 0], rects[:, 1], rects[:, 2], rects[:, 3]
    c0 = np.stack([x, y], -1)
    c1 = np.stack([x + bw, y], -1)
    c2 = np.stack([x + bw, y + bh], -1)
    c3 = np.stack([x, y + bh], -1)
    for a, b in ((c0, c1), (c1, c2), (c2, c3), (c3, c0)):
        draw_segments(img, a, b, color=color, thickness=thickness)
    return img


# ---------------------------------------------------------------------------
# text (5x7 bitmap font: digits, uppercase, a few symbols — enough for
# status bars and class labels; FrameDrawer uses cv::putText)

_GLYPHS = {
    "0": "01110 10001 10011 10101 11001 10001 01110",
    "1": "00100 01100 00100 00100 00100 00100 01110",
    "2": "01110 10001 00001 00010 00100 01000 11111",
    "3": "11110 00001 00001 01110 00001 00001 11110",
    "4": "00010 00110 01010 10010 11111 00010 00010",
    "5": "11111 10000 11110 00001 00001 10001 01110",
    "6": "00110 01000 10000 11110 10001 10001 01110",
    "7": "11111 00001 00010 00100 01000 01000 01000",
    "8": "01110 10001 10001 01110 10001 10001 01110",
    "9": "01110 10001 10001 01111 00001 00010 01100",
    "A": "01110 10001 10001 11111 10001 10001 10001",
    "B": "11110 10001 10001 11110 10001 10001 11110",
    "C": "01110 10001 10000 10000 10000 10001 01110",
    "D": "11110 10001 10001 10001 10001 10001 11110",
    "E": "11111 10000 10000 11110 10000 10000 11111",
    "F": "11111 10000 10000 11110 10000 10000 10000",
    "G": "01110 10001 10000 10111 10001 10001 01111",
    "H": "10001 10001 10001 11111 10001 10001 10001",
    "I": "01110 00100 00100 00100 00100 00100 01110",
    "J": "00111 00010 00010 00010 00010 10010 01100",
    "K": "10001 10010 10100 11000 10100 10010 10001",
    "L": "10000 10000 10000 10000 10000 10000 11111",
    "M": "10001 11011 10101 10101 10001 10001 10001",
    "N": "10001 11001 10101 10011 10001 10001 10001",
    "O": "01110 10001 10001 10001 10001 10001 01110",
    "P": "11110 10001 10001 11110 10000 10000 10000",
    "Q": "01110 10001 10001 10001 10101 10010 01101",
    "R": "11110 10001 10001 11110 10100 10010 10001",
    "S": "01111 10000 10000 01110 00001 00001 11110",
    "T": "11111 00100 00100 00100 00100 00100 00100",
    "U": "10001 10001 10001 10001 10001 10001 01110",
    "V": "10001 10001 10001 10001 10001 01010 00100",
    "W": "10001 10001 10001 10101 10101 11011 10001",
    "X": "10001 01010 00100 00100 00100 01010 10001",
    "Y": "10001 01010 00100 00100 00100 00100 00100",
    "Z": "11111 00001 00010 00100 01000 10000 11111",
    "-": "00000 00000 00000 01110 00000 00000 00000",
    ".": "00000 00000 00000 00000 00000 00100 00100",
    ":": "00000 00100 00100 00000 00100 00100 00000",
    "/": "00001 00010 00010 00100 01000 01000 10000",
    "=": "00000 00000 11111 00000 11111 00000 00000",
    "%": "11001 11010 00010 00100 01000 01011 10011",
    " ": "00000 00000 00000 00000 00000 00000 00000",
}
_FONT = {
    ch: np.array([[c == "1" for c in row] for row in rows.split()], bool)
    for ch, rows in _GLYPHS.items()
}


def draw_text(img: np.ndarray, xy, text: str, color=(0, 0, 0),
              scale: int = 1) -> np.ndarray:
    """Stamp 5x7 bitmap text at top-left xy; unknown chars render blank."""
    x0, y0 = int(xy[0]), int(xy[1])
    h, w = img.shape[:2]
    color = np.asarray(color, np.uint8)
    for ch in str(text).upper():
        g = _FONT.get(ch)
        if g is not None:
            glyph = np.kron(g, np.ones((scale, scale), bool))
            gh, gw = glyph.shape
            ys, xs = slice(max(y0, 0), min(y0 + gh, h)), slice(max(x0, 0), min(x0 + gw, w))
            if ys.stop > ys.start and xs.stop > xs.start:
                sub = glyph[ys.start - y0:ys.stop - y0, xs.start - x0:xs.stop - x0]
                img[ys, xs][sub] = color
        x0 += 6 * scale
    return img


# ---------------------------------------------------------------------------
# PNG output

def encode_png(img: np.ndarray) -> bytes:
    """Minimal RGB8 PNG encoder (stdlib zlib only)."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    if img.ndim == 2:
        img = np.repeat(img[:, :, None], 3, axis=2)
    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def save_png(path: str, img: np.ndarray) -> str:
    with open(path, "wb") as f:
        f.write(encode_png(img))
    return path


def gray_to_rgb(img: np.ndarray) -> np.ndarray:
    """Float/uint8 grayscale [H,W] -> RGB uint8 canvas."""
    a = np.asarray(img)
    if a.dtype != np.uint8:
        a = np.clip(a, 0, 255).astype(np.uint8)
    if a.ndim == 2:
        a = np.repeat(a[:, :, None], 3, axis=2)
    return np.ascontiguousarray(a)


def to_numpy(x):
    """A tensor on any device (through a host copy), or anything array-like,
    as numpy; None stays None."""
    if x is None:
        return None
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)
