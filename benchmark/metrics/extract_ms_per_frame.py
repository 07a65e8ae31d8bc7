"""Front end (ops/image, ops/orb through runtime/scan_tracker.extract_batch):
host-clock milliseconds of the ``extract_batch`` span (synchronised on both
sides) over the window, per frame of the window."""

SPANS = ("extract_batch",)


def read(rec):
    t = rec["spans"].get("extract_batch")
    if not t:
        return None
    return 1e3 * sum(t) / rec["window"]["frames"]
