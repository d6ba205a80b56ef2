"""App-layer utilities: CLI parsing, camera controller, render info — a
copy of ``ptrt_tpu/app/app_utils.py``.

Rebuild of the reference's app glue (``app_utils.cuh:211-425``,
``RTapp_utils.cuh:102-247``).  The GLFW dependency is replaced by an
``InputState`` the host loop fills however it likes (pygame, curses, a
script, a test); ``CameraController.update`` consumes it exactly like the
reference's WASD+mouse logic.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field


@dataclass
class RenderConfig:
    """``RenderConfig`` + ``parseArguments`` (``app_utils.cuh:372-416``)."""

    scene_id: int = 0
    width: int = 800
    height: int = 600
    output_name: str = "output"
    show_help: bool = False
    bvh_leaf_target: int = 12
    bvh_leaf_tol: int = 5


USAGE = """
Usage: {prog} [options]

Options:
  -s, --scene <id>    Select scene (0-10)
  -w, --width <size>  Set image width (default: 800)
  -h, --height <size> Set image height (default: 600)
  -o, --output <name> Output filename (without extension)
  --help              Show this help message

Scenes (PT backend):
  0: Lit Test Scene          6: USNM Object
  1: Presidents              7: Custom Scene
  2: Statues                 8: Ultimate Model Showcase
  3: X3D Components          9: Cornell Gems
  4: Abstract Pair          10: Material Matrix (Cubes)
  5: Vase
"""


def parse_arguments(argv: list[str]) -> RenderConfig:
    cfg = RenderConfig()
    i = 0
    while i < len(argv):
        arg = argv[i]
        if arg == "--help":
            cfg.show_help = True
            return cfg
        if arg in ("-s", "--scene") and i + 1 < len(argv):
            i += 1
            cfg.scene_id = int(argv[i])
        elif arg in ("-w", "--width") and i + 1 < len(argv):
            i += 1
            cfg.width = int(argv[i])
        elif arg in ("-h", "--height") and i + 1 < len(argv):
            i += 1
            cfg.height = int(argv[i])
        elif arg in ("-o", "--output") and i + 1 < len(argv):
            i += 1
            cfg.output_name = argv[i]
        else:
            print(f"Unknown argument: {arg}")
            cfg.show_help = True
            return cfg
        i += 1
    return cfg


@dataclass
class InputState:
    """Host-agnostic input snapshot (replaces GLFW polling)."""

    keys: set = field(default_factory=set)  # e.g. {"w", "a", "shift"}
    mouse_dx: float = 0.0
    mouse_dy: float = 0.0  # positive = up, like the reference's inverted dy


class CameraController:
    """WASD+mouse fly camera (``app_utils.cuh:211-302``)."""

    def __init__(self):
        self.pos = [0.0, 0.0, 3.0]
        self.yaw = -90.0
        self.pitch = 0.0
        self.speed = 1.0
        self.sensitivity = 0.12
        self.capture_mouse = True
        self._c_prev = False

    def init_from_scene(self, scene) -> None:
        cam = scene.camera
        self.pos = [float(cam.origin.x), float(cam.origin.y),
                    float(cam.origin.z)]
        f = (-float(cam.w.x), -float(cam.w.y), -float(cam.w.z))
        self.yaw = math.degrees(math.atan2(f[2], f[0]))
        self.pitch = math.degrees(math.asin(max(-1.0, min(1.0, f[1]))))

    @staticmethod
    def forward_from_yaw_pitch(yaw_deg: float, pitch_deg: float):
        cy, sy = math.cos(math.radians(yaw_deg)), math.sin(math.radians(yaw_deg))
        cp, sp = (math.cos(math.radians(pitch_deg)),
                  math.sin(math.radians(pitch_deg)))
        f = (cy * cp, sp, sy * cp)
        n = math.sqrt(sum(c * c for c in f))
        return tuple(c / n for c in f)

    def apply_mouse(self, inp: InputState) -> None:
        if not self.capture_mouse:
            return
        self.yaw += inp.mouse_dx * self.sensitivity
        self.pitch += inp.mouse_dy * self.sensitivity
        self.pitch = max(-89.9, min(89.9, self.pitch))

    def apply_keyboard(self, inp: InputState, dt: float) -> None:
        boost = 2.5 if "shift" in inp.keys else 1.0
        v = self.speed * boost * dt * 5
        fwd = self.forward_from_yaw_pitch(self.yaw, self.pitch)
        up = (0.0, 1.0, 0.0)
        right = (fwd[2] * up[1] - fwd[1] * up[2],
                 fwd[0] * up[2] - fwd[2] * up[0],
                 fwd[1] * up[0] - fwd[0] * up[1])
        rn = math.sqrt(sum(c * c for c in right))
        right = tuple(c / max(rn, 1e-9) for c in right)

        def move(d, s):
            self.pos = [self.pos[i] + d[i] * s for i in range(3)]

        if "w" in inp.keys:
            move(fwd, v)
        if "s" in inp.keys:
            move(fwd, -v)
        if "a" in inp.keys:
            move(right, -v)
        if "d" in inp.keys:
            move(right, v)
        if "space" in inp.keys:
            move(up, v)
        if "ctrl" in inp.keys:
            move(up, -v)
        c_now = "c" in inp.keys
        if c_now and not self._c_prev:
            self.capture_mouse = not self.capture_mouse
        self._c_prev = c_now

    def update(self, scene, inp: InputState, dt: float) -> None:
        """Apply input and push the camera into the scene
        (``app_utils.cuh:296-302``)."""
        self.apply_mouse(inp)
        self.apply_keyboard(inp, dt)
        fwd = self.forward_from_yaw_pitch(self.yaw, self.pitch)
        target = tuple(self.pos[i] + fwd[i] for i in range(3))
        scene.set_camera(tuple(self.pos), target, (0, 1, 0),
                         float(scene.camera.fov))


def print_render_info(scene_name: str, width: int, height: int) -> None:
    """``printRenderInfo`` (``app_utils.cuh:418-425``)."""
    print(f"Scene:      {scene_name:<26}")
    print(f"Resolution: {width} x {height}")
