"""Kernels a frame launches: the profiled stretch's kernels (memory copies
and sets left out) over its frames."""


def read(run):
    p = run.profile
    return p.launches / p.frames if p is not None and p.launches else None
