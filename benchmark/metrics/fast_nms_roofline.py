"""Kernel (ops/fast_nms -> csrc/fast_nms.cu, the ``fast_nms_kernel`` launch
that covers every pyramid level of a chunk): the least time the published
H100 peaks allow for the work FAST-9/16 + 3x3 NMS + the per-cell maximum
need at the cell's pyramid shapes, over the kernel's mean device time from
the profiler, in percent. The larger of two bounds binds; with the SM clock
at 1980 MHz it is the integer one.

What the algorithm needs, counted from the shapes and not from any
implementation:
- bytes: every pyramid pixel read once, as the 8-bit grey level the front
  end receives (1 byte), and every cell maximum written once (4 bytes).
- integer operations per pixel, each a 16-bit value (grey levels and their
  differences fit), counting a two- or three-input min or max, or an add
  fused into one, as one operation, and sharing everything that neighbouring
  pixels can share:
    FAST, per side (bright, dark): 16 arc extrema (the image's min, or max,
    over each of the 16 nine-pixel arcs of the ring: distinct structuring
    elements, so each needs at least one operation per pixel), the maximum
    of the 16 (8 three-input operations), the centre's difference fused
    into it: 24; both sides and their maximum: 49
    NMS: the 3x3 maximum, separable with three-input operations (2), the
    comparison with the centre and the select (1): 3
    border mask and packing score and index: 1
    the cell maximum: 256 values into one per 16 x 16 cell (about 1 a pixel
    with three-input operations over the cell: 0.5, counted as 0)
  in all 53 a pixel, issued at 132 SMs x 64 INT32 lanes x 2 (16x2 packed)
  per clock.
"""

from harness import peaks

OPS_PER_PIXEL = 53
READ_BYTES_PER_PIXEL = 1
WRITE_BYTES_PER_CELL = 4
CELL = 16
KERNEL = "fast_nms_kernel"


def level_sizes(height: int, width: int, n_levels: int, scale_factor: float):
    return [(int(round(height / scale_factor ** l)), int(round(width / scale_factor ** l)))
            for l in range(n_levels)]


def bound_s(frames: int, height: int, width: int, n_levels: int, scale_factor: float,
            clock_hz: float) -> tuple:
    """(seconds, "operations" or "bytes") of the least time for one launch
    over ``frames`` frames."""
    sizes = level_sizes(height, width, n_levels, scale_factor)
    px = frames * sum(h * w for h, w in sizes)
    cells = frames * sum(-(-h // CELL) * -(-w // CELL) for h, w in sizes)
    t_bytes = (px * READ_BYTES_PER_PIXEL + cells * WRITE_BYTES_PER_CELL) / peaks.HBM_BYTES_PER_S
    lanes = peaks.SMS * peaks.INT32_LANES_PER_SM * peaks.LANES_PER_INT32
    t_ops = px * OPS_PER_PIXEL / (lanes * clock_hz)
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def read(rec):
    prof = rec.get("profile")
    if prof is None or rec["mode"] != "chunked" or not rec.get("device"):
        return None
    hits = [v for k, v in prof["ops"].items() if KERNEL in k]
    count = sum(v["count"] for v in hits)
    if not count:
        return None
    per_launch = sum(v["device_s"] for v in hits) / count
    cam, orb = rec["config"]["camera"], rec["config"]["port"]["orb"]
    t, _ = bound_s(int(rec["traffic"]["chunk"]), int(cam["height"]), int(cam["width"]),
                   int(orb["n_levels"]), float(orb["scale_factor"]), rec["device"]["sm_clock_hz"])
    return 100.0 * t / per_launch
