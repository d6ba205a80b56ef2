"""Set-up seconds of the first frame: the frame program's warm-up on a
side stream, its CUDA-graph capture and first replay (the
``setup.first_frame`` span)."""


def read(run):
    s = run.spans.seconds("setup.first_frame")
    return s[0] if s else None
