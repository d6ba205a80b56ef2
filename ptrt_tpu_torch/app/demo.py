"""Demo runner — the game ``main()`` analog; the counterpart of
``ptrt_tpu/app/demo.py``.

``python -m ptrt_tpu_torch.app.demo --backend pt|rt --frames N -w W -h H
-o OUT`` renders a demo scene (``-s ID``: ``app/demo_scenes.py`` for the
path tracer, ``app/rt_demo_scenes.py`` for the one-bounce RT backend) for N
frames on the card and writes OUT.ppm and OUT.png; it prints the first
frame's time, the frame rate of the rest and the card's name and power
limit.  ``--cpu`` renders on the CPU (the kernels' plain versions); without
it and without a card it raises, as ``Scene`` does.  ``--preset NAME``
sets the PT scene's performance preset; ``--interactive`` or ``--viewer
pygame|http`` runs the frame loop of ``app/viewer.py`` instead.
"""

from __future__ import annotations

import subprocess
import sys
import time


def card_line(device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them (the
    torch name alone where ``nvidia-smi`` cannot say); "cpu" on the CPU."""
    import torch

    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", str(index)],
            capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return f"{torch.cuda.get_device_name(index)}, power limit not read"


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    backend = "pt"
    frames = 8
    preset = None
    device = "cuda"
    interactive = None  # None | "auto" | "pygame" | "http"
    rest = []
    i = 0
    while i < len(argv):
        if argv[i] == "--backend" and i + 1 < len(argv):
            i += 1
            backend = argv[i]
        elif argv[i] == "--frames" and i + 1 < len(argv):
            i += 1
            frames = int(argv[i])
        elif argv[i] == "--preset" and i + 1 < len(argv):
            i += 1
            preset = argv[i]
        elif argv[i] == "--interactive":
            interactive = "auto"
        elif argv[i] == "--viewer" and i + 1 < len(argv):
            i += 1
            interactive = argv[i]  # pygame | http
        elif argv[i] == "--cpu":
            device = "cpu"
        else:
            rest.append(argv[i])
        i += 1
    if backend not in ("pt", "rt"):
        raise ValueError(f"--backend {backend}: pt or rt")

    from ptrt_tpu_torch.app.app_utils import (USAGE, parse_arguments,
                                              print_render_info)
    from ptrt_tpu_torch.utils.imageio import save_png, save_ppm

    cfg = parse_arguments(rest)
    if cfg.show_help:
        print(USAGE.format(prog="python -m ptrt_tpu_torch.app.demo"))
        return 0

    import torch

    if backend == "rt":
        from ptrt_tpu_torch.app.rt_demo_scenes import build_scene_by_id

        scene, name = build_scene_by_id(cfg.scene_id, cfg.width, cfg.height,
                                        device=device)
    else:
        from ptrt_tpu_torch.app.demo_scenes import build_scene_by_id

        scene, name = build_scene_by_id(cfg.scene_id, cfg.width, cfg.height,
                                        device=device)
        if preset:
            scene.set_performance_preset(preset)

    print_render_info(name, cfg.width, cfg.height)
    card = card_line(scene.device)
    sync = (lambda: torch.cuda.synchronize(scene.device)) \
        if scene.device.type == "cuda" else (lambda: None)

    if interactive is not None:
        if backend == "rt":
            print("interactive viewer currently drives the PT backend")
            return 1
        from ptrt_tpu_torch.app.viewer import run_interactive

        n = run_interactive(scene, prefer=interactive,
                            max_frames=frames if frames > 8 else None)
        print(f"presented {n} frames")
        return 0

    t0 = time.perf_counter()
    img = scene.render_frame_device()
    sync()
    print(f"first frame (kernel build and set-up included): "
          f"{1e3 * (time.perf_counter() - t0):.1f} ms [{card}]")
    t0 = time.perf_counter()
    for _ in range(max(0, frames - 1)):
        img = scene.render_frame_device()
    sync()
    dt = time.perf_counter() - t0
    if frames > 1:
        print(f"{frames - 1} frames: {dt:.3f} s, "
              f"{1e3 * dt / (frames - 1):.2f} ms a frame "
              f"({(frames - 1) / max(dt, 1e-9):.1f} FPS) [{card}]")
    img = img.cpu().numpy()
    save_ppm(cfg.output_name + ".ppm", img)
    save_png(cfg.output_name + ".png", img)
    print(f"wrote {cfg.output_name}.ppm / .png")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
