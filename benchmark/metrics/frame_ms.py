"""Milliseconds a frame: the window's length over the frames presented in
it (the upstream's average FPS, inverted)."""

from benchmark import window


def read(run):
    return window.frame_ms(run.presents)
