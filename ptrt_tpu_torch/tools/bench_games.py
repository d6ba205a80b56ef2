#!/usr/bin/env python
"""Frame rates of the fused game loops (the port's counterpart of the
repo's ``tools/bench_games.py``): each game's ``run_fused`` (the step,
the scene update and the frame; on the card each timed frame one CUDA
graph replay) at the given size under each preset, N timed frames after
the warm-up frame and the capture.

    python -m ptrt_tpu_torch.tools.bench_games [--device cuda|cpu]

Env: PTRT_GAME_W/H (default 640x360), PTRT_GAME_FRAMES (default 60),
PTRT_GAME_PRESETS (comma list, default fast,performance,balanced),
PTRT_GAMES (comma list, default cube_slider,fluid,tycoon).  Prints the
reference's line a (game, preset) and, last, its JSON list (each entry
with the card's name and power limit).  A game that fails fails the run.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from ptrt_tpu_torch.app.demo import card_line
from ptrt_tpu_torch.games import cube_slider, fluid, tycoon

GAMES = {"cube_slider": cube_slider.run_fused, "fluid": fluid.run_fused,
         "tycoon": tycoon.run_fused}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    w = int(os.environ.get("PTRT_GAME_W", 640))
    h = int(os.environ.get("PTRT_GAME_H", 360))
    n = int(os.environ.get("PTRT_GAME_FRAMES", 60))
    presets = os.environ.get("PTRT_GAME_PRESETS",
                             "fast,performance,balanced").split(",")
    games = os.environ.get("PTRT_GAMES",
                           "cube_slider,fluid,tycoon").split(",")
    unknown = [g for g in games if g not in GAMES]
    if unknown:
        raise ValueError(f"unknown games {unknown}; known: {list(GAMES)}")
    card = card_line(torch.device(args.device))
    results = []
    for game in games:
        for preset in presets:
            t0 = time.perf_counter()
            _, fps, _ = GAMES[game](n_frames=n, width=w, height=h,
                                    preset=preset, device=args.device)
            wall = time.perf_counter() - t0
            results.append({"game": game, "preset": preset, "w": w, "h": h,
                            "fps": round(fps, 2), "wall_s": round(wall, 1),
                            "frames": n, "card": card})
            print(f"{game:12s} {preset:12s} {w}x{h}: {fps:8.2f} FPS "
                  f"(total wall {wall:.1f}s incl warm-up and capture) "
                  f"[{card}]", flush=True)
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
