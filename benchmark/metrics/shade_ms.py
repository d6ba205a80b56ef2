"""Device milliseconds a frame of the kernels ``layers/*.json`` map to
``shade_ms``, over the profiled stretch."""


def read(run):
    p = run.profile
    if p is None:
        return None
    ms = p.buckets_ms.get("shade_ms", 0.0)
    return ms if ms > 0.0 else None
