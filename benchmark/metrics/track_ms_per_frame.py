"""Chunk tracking (the chunk program of runtime/scan_tracker: the per-frame
step, pose LM, matching, the keyframe branch with local mapping and the
windowed BA, the object pass in an object mode): host-clock milliseconds of
the ``extract_track`` span less the ``extract_batch`` span inside it, over
the window, per frame of the window."""

SPANS = ("extract_track", "extract_batch")


def read(rec):
    outer = rec["spans"].get("extract_track")
    inner = rec["spans"].get("extract_batch")
    if not outer or inner is None:
        return None
    return 1e3 * (sum(outer) - sum(inner)) / rec["window"]["frames"]
