"""Between-chunk passes (ChunkedTracker._maybe_merge_objects,
_maybe_maintain, _maybe_close_loops, _maybe_relocalize: objects/merge,
runtime/compaction, runtime/loop_closing, solvers/pnp): host-clock
milliseconds of the four spans over the window, per frame of the window.
A pass that finds nothing to do returns at once and still counts."""

SPANS = ("merge_objects", "maintain", "close_loops", "relocalize")


def read(rec):
    spans = [rec["spans"].get(p) for p in SPANS]
    if any(s is None for s in spans) or not any(spans):
        return None
    return 1e3 * sum(sum(s) for s in spans) / rec["window"]["frames"]
