"""Device: kernel launches (the cudaLaunchKernel family of runtime calls in
the profiler's trace) over the traced stretch of whole chunks, per frame."""


def read(rec):
    prof = rec.get("profile")
    if prof is None or rec["mode"] != "chunked":
        return None
    return prof["launches"] / rec["traced_frames"]
