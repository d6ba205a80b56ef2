#!/usr/bin/env python
"""The fidelity corpus, rendered by the port.

A copy in port terms of ``tools/make_fidelity.py``'s seven recipes (that
tool renders them with the JAX package): four procedural scenes, each with
the feature set of one of the original engine's showcase screenshots
(clear, dark and frosted glass; a thin-film iridescent body; copper and
marble under a spot; glossy spheres under a strong light that the firefly
clamp and SVGF must keep speckle-free), and a frame of each of the three
games.  Each renders ``frames`` frames under the "balanced" preset with
motion vectors off, and the last frame is the image.

    python -m ptrt_tpu_torch.tools.fidelity [--w 640] [--h 360]
        [--frames 48] [--only a,b] [--out DIR] [--cpu]

Writes ``DIR/<name>.png`` (``build/fidelity/`` by default; never
``docs/fidelity/``, which holds the JAX package's own renders) and prints
a line a scene: its shape, mean, the first frame's ms and the ms a frame
of the rest, beside the card's name and power limit.  It renders on the
card; ``--cpu`` renders on the CPU (the kernels' plain versions), and
without a card and without ``--cpu`` it raises.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ptrt_tpu_torch.build import REPO_ROOT

OUT_DIR = os.path.join(REPO_ROOT, "build", "fidelity")


def _f32(v) -> torch.Tensor:
    """A 0-d float32 host tensor (the reference's ``jnp.float32``)."""
    return torch.tensor(np.float32(v))


def _sky_like_reference(sc) -> None:
    """The showcase shots use a blue-grey gradient with a bright horizon."""
    sc.set_sky_gradient((0.18, 0.28, 0.45), (0.75, 0.72, 0.70))


def scene_glass_sculptures(w: int, h: int, device="cuda"):
    """Clear glass, low-transmission (dark) glossy and frosted glass bodies
    on pedestals against the gradient sky."""
    from ptrt_tpu_torch.scene.materials import Material, Materials
    from ptrt_tpu_torch.scene.pt_scene import Scene

    sc = Scene(w, h, device=device)
    _sky_like_reference(sc)
    pedestal = Material.make((0.75, 0.78, 0.85), 0.4)
    # stacked spheres as a "bust"
    for (x, mat) in [(-2.2, Materials.Glass()),
                     (0.0, Material.make((0.02, 0.02, 0.02), 0.15,
                                         transmission=0.25, ior=1.5)),
                     (2.2, Materials.FrostedGlass())]:
        base = sc.add_cube(pedestal)
        base.transform.set_position(x, -1.1, 5.0).set_scale(1.2, 0.4, 1.2)
        body = sc.add_sphere(48, mat)
        body.transform.set_position(x, -0.1, 5.0).set_scale(0.75)
        head = sc.add_sphere(48, mat)
        head.transform.set_position(x, 0.85, 5.0).set_scale(0.45)
    sc.add_plane_xz(-1.3, 60.0, Material.make((0.45, 0.52, 0.65), 0.55))
    sc.add_point_light((4, 6, 0), (1.0, 0.97, 0.9), 14.0, range=50.0,
                       radius=0.4)
    sc.set_camera((0, 0.6, -0.5), (0, 0.0, 5.0), fov=55)
    return sc


def scene_iridescent(w: int, h: int, device="cuda"):
    """A dark thin-film iridescent body floating over the gradient sky."""
    from ptrt_tpu_torch.scene.materials import Material, Materials
    from ptrt_tpu_torch.scene.pt_scene import Scene

    sc = Scene(w, h, device=device)
    _sky_like_reference(sc)
    irid = Materials.OilSlick()
    body = sc.add_sphere(64, irid)
    body.transform.set_position(0.0, 0.6, 4.5).set_scale(1.5, 0.9, 1.5)
    cap = sc.add_sphere(48, irid)
    cap.transform.set_position(0.0, 1.35, 4.5).set_scale(0.8, 0.55, 0.8)
    ped = sc.add_cube(Material.make((0.7, 0.73, 0.8), 0.4))
    ped.transform.set_position(2.6, -1.0, 5.5).set_scale(1.0, 0.4, 1.0)
    chrome = sc.add_sphere(48, Materials.Chrome())
    chrome.transform.set_position(2.6, -0.1, 5.5).set_scale(0.6)
    sc.add_plane_xz(-1.3, 60.0, Material.make((0.45, 0.52, 0.65), 0.55))
    sc.add_point_light((-5, 5, -2), (1.0, 1.0, 1.0), 10.0, range=50.0,
                       radius=0.5)
    sc.set_camera((0, 0.8, -0.8), (0.3, 0.4, 4.5), fov=55)
    return sc


def scene_copper_bust(w: int, h: int, device="cuda"):
    """Copper and marble under a spot: a soft spot shadow on a dark set."""
    from ptrt_tpu_torch.scene.materials import Material, Materials
    from ptrt_tpu_torch.scene.pt_scene import Scene

    sc = Scene(w, h, device=device)
    sc.set_sky_gradient((0.04, 0.04, 0.06), (0.0, 0.0, 0.0))
    bust = sc.add_sphere(64, Materials.Copper())
    bust.transform.set_position(-1.2, 0.2, 4.0).set_scale(0.8, 1.1, 0.8)
    marble = sc.add_sphere(64, Materials.MarbleCarrara())
    marble.transform.set_position(1.4, 0.0, 4.2).set_scale(0.9)
    sc.add_plane_xz(-1.2, 50.0, Material.make((0.8, 0.8, 0.8), 0.7))
    sc.add_spot_light((-3, 5, 2), (0.5, -1, 0.5), (1, 1, 1), 40.0,
                      inner_cone=0.1, outer_cone=0.35, radius=0.25)
    sc.add_point_light((3, 4, 2), (0.5, 0.5, 1.0), 6.0, range=30.0,
                       radius=0.2)
    sc.set_camera((0, 0.5, -0.5), (0, 0.2, 4.0), fov=55)
    return sc


def scene_firefly(w: int, h: int, device="cuda"):
    """High-frequency glossy geometry, a strong off-screen light and
    specular caustic paths: the firefly clamp and SVGF must keep the frame
    speckle-free."""
    from ptrt_tpu_torch.scene.materials import Material, Materials
    from ptrt_tpu_torch.scene.pt_scene import Scene

    sc = Scene(w, h, device=device)
    sc.set_sky_gradient((0.10, 0.12, 0.2), (0.3, 0.28, 0.26))
    rng = np.random.default_rng(7)
    dark_gloss = Material.make((0.03, 0.03, 0.035), 0.25)
    for i in range(40):
        m = sc.add_sphere(16, dark_gloss if i % 3 else Materials.Chrome())
        x, y, z = rng.uniform(-3, 3), rng.uniform(-1, 2), rng.uniform(3.5, 7)
        m.transform.set_position(x, y, z).set_scale(
            *(rng.uniform(0.2, 0.7, size=3)))
    sc.add_point_light((0, 8, -2), (1.0, 0.9, 0.8), 60.0, range=80.0,
                       radius=0.15)
    sc.set_camera((0, 0.5, -1.0), (0, 0.4, 5.0), fov=65)
    return sc


def game_cube_slider(w: int, h: int, device="cuda"):
    """The cube slider's track after 12 ticks steering right."""
    from ptrt_tpu_torch.games import cube_slider

    u, sc = cube_slider.build_scene(w, h, device=device)
    state = cube_slider.init_state(device=sc.device)
    for _ in range(12):
        state = cube_slider.step(state, _f32(0.4), _f32(0.05))
    cube_slider.sync_scene(u, sc, state)
    return sc


def game_fluid(w: int, h: int, device="cuda"):
    """The water pool's 32x32 surface after 10 ticks of its wave."""
    from ptrt_tpu_torch.games import fluid
    from ptrt_tpu_torch.scene.unified import UnifiedSceneBuilder

    u, sc, state = fluid.build_scene(w, h, n=32, device=device)
    for _ in range(10):
        state = fluid.step(state, _f32(1.0 / 30.0), _f32(6.0), _f32(0.995))
    tris = fluid.heightfield_to_triangles(state.height).cpu().numpy()
    u.find_object("fluid").set_triangles(tris)
    UnifiedSceneBuilder.update_pt_scene(sc, u)
    return sc


def game_tycoon(w: int, h: int, device="cuda"):
    """The tycoon map with three buildings placed, half a second on."""
    from ptrt_tpu_torch.games.tycoon import TycoonGame

    g = TycoonGame(w, h, device=device)
    g.place_building(2, 2, 0)
    g.place_building(3, 2, 1)
    g.place_building(2, 3, 2)
    g.update(0.5)
    return g.scene


SCENES = {
    "glass_sculptures": scene_glass_sculptures,
    "iridescent": scene_iridescent,
    "copper_bust": scene_copper_bust,
    "firefly": scene_firefly,
    "game_cube_slider": game_cube_slider,
    "game_fluid": game_fluid,
    "game_tycoon": game_tycoon,
}


def build(name: str, w: int, h: int, device="cuda"):
    """The recipe's scene under the balanced preset, motion vectors off."""
    sc = SCENES[name](w, h, device)
    sc.set_performance_preset("balanced")
    sc.perf.enable_motion_vectors = False
    return sc


def render(name: str, w: int, h: int, frames: int = 48, device="cuda",
           stats: dict | None = None) -> np.ndarray:
    """Recipe ``name`` at w x h: the last of ``frames`` balanced frames,
    (h, w, 3) uint8.  ``stats`` receives "first_ms" (the first frame:
    the kernels' build on first use, the scene's tables and its programs'
    capture included) and "frame_ms" (the mean of the others; None for
    one frame), each with the card synchronized after it."""
    sc = build(name, w, h, device)
    sync = ((lambda: torch.cuda.synchronize(sc.device))
            if sc.device.type == "cuda" else (lambda: None))
    t0 = time.perf_counter()
    img = sc.render_frame_device()
    sync()
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(frames - 1):
        img = sc.render_frame_device()
    sync()
    rest = time.perf_counter() - t0
    if stats is not None:
        stats["first_ms"] = 1e3 * first
        stats["frame_ms"] = 1e3 * rest / (frames - 1) if frames > 1 else None
    return img.cpu().numpy()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--w", type=int, default=640)
    ap.add_argument("--h", type=int, default=360)
    ap.add_argument("--frames", type=int, default=48,
                    help="accumulation frames per image")
    ap.add_argument("--only", type=str, default="",
                    help="comma-separated scene names (default: all)")
    ap.add_argument("--out", type=str, default=OUT_DIR)
    ap.add_argument("--cpu", action="store_true",
                    help="render on the CPU (the kernels' plain versions)")
    args = ap.parse_args(argv)
    if args.frames < 1:
        raise ValueError("--frames must be at least 1")

    from ptrt_tpu_torch.app.demo import card_line
    from ptrt_tpu_torch.utils.imageio import save_png

    names = args.only.split(",") if args.only else list(SCENES)
    unknown = [n for n in names if n not in SCENES]
    if unknown:
        raise ValueError(f"unknown scenes {unknown}; known: {list(SCENES)}")
    device = "cpu" if args.cpu else "cuda"
    os.makedirs(args.out, exist_ok=True)
    card = None
    for name in names:
        st = {}
        img = render(name, args.w, args.h, args.frames, device, st)
        card = card or card_line(torch.device(device))
        save_png(os.path.join(args.out, f"{name}.png"), img)
        per = ("" if st["frame_ms"] is None else
               f", {st['frame_ms']:.2f} ms a frame of the other "
               f"{args.frames - 1}")
        print(f"fidelity {name} {img.shape} mean {float(img.mean()):.4f}: "
              f"first frame {st['first_ms']:.1f} ms{per} [{card}]",
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
