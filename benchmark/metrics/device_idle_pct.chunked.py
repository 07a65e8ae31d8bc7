"""Device, chunked path: the share of the traced stretch's wall time in which
no operation ran on the card (1 - the union of device operation intervals
from the profiler's trace / the stretch's wall time), in percent."""


def read(rec):
    prof = rec.get("profile")
    if prof is None or rec["mode"] != "chunked" or prof["wall_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["wall_s"])
