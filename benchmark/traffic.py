"""The one traffic generator: what each frame of a cell asks, read from its
traffic file (``traffic/<name>.json``) and the run's seed.

A traffic file gives the quality preset (``PerformanceSettings`` fields
set on the scene), the camera path (``fixed``: the scene's own camera;
``orbit``: a circle about ``center`` at ``radius`` and ``height``,
``degrees_per_frame`` a frame from a start angle drawn from the seed),
the bound below which the first frame index is drawn, the frames of
set-up after the capturing one, the frames a traced run profiles, and the
check's frame and pixel count.  The seed draws, in this order: the first
frame index, the orbit's start angle, the checked frame, the seed of the
checked pixels and the seed of the scene's own data (an HDRI's map)."""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


@dataclass
class Draws:
    first_index: int
    start_degrees: float
    check_frame: int  # the window frame the check compares
    pixel_seed: int
    scene_seed: int


def draws(traffic: dict, seed: int) -> Draws:
    rng = np.random.default_rng(int(seed) % (1 << 64))
    first = int(rng.integers(0, traffic["frame_index_start_below"]))
    start = float(rng.uniform(0.0, 360.0))
    chk = traffic["check"]
    frame = int(rng.integers(chk["frame_after"], chk["frame_before"]))
    return Draws(first, start, frame, int(rng.integers(0, 1 << 62)),
                 int(rng.integers(0, 1 << 31)))


def apply_preset(scene, traffic: dict) -> None:
    """Set the traffic's quality preset on the port's scene
    (``scene.perf``)."""
    for key, value in traffic["preset"].items():
        if not hasattr(scene.perf, key):
            raise KeyError(f"the preset has no setting {key!r}")
        setattr(scene.perf, key, value)


def camera_at(traffic: dict, d: Draws, frame: int):
    """(lookfrom, lookat, fov) of frame ``frame`` (counted from the first
    frame of set-up) on the traffic's path, or None for the scene's own
    camera."""
    cam = traffic["camera"]
    if cam["path"] == "fixed":
        return None
    if cam["path"] != "orbit":
        raise ValueError(f"unknown camera path {cam['path']!r}")
    a = math.radians(d.start_degrees + cam["degrees_per_frame"] * frame)
    cx, cy, cz = cam["center"]
    r = cam["radius"]
    return ((cx + r * math.sin(a), cam["height"], cz - r * math.cos(a)),
            (cx, cy, cz), cam["fov"])
