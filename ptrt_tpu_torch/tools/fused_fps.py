"""Host-clock frame rates of the fused games and the balanced 1080p frame,
for this tree or another one.

    python3 ptrt_tpu_torch/tools/fused_fps.py [--tree DIR] [--reps 3]

With the package of DIR (this checkout without ``--tree``): each fused
game's ``run_fused`` at the reference's defaults (cube slider and tycoon
at 640x360 "fast", 60 frames; the 24x24 fluid at 320x180 "fast", 30
frames) ``--reps`` times, frames a second each; then the bench scene at
1920x1080 in the "balanced" preset, the camera orbiting, ms a frame on the
host clock (``render_frame`` to the host, after a warm-up) for 10 frames.
Prints one JSON line with the card's name and power limit.  Host rates
spread 30-60% between machines: compare two trees only in one call, in
turns (parent, change, change, parent).
"""

import argparse
import json
import math
import os
import subprocess
import sys
import time


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", help="measure the checkout in this directory")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    tree = os.path.abspath(args.tree or here)
    sys.path.insert(0, tree)
    import torch

    from ptrt_tpu_torch.app.bench_scene import build_bench_scene
    from ptrt_tpu_torch.games import cube_slider, fluid, tycoon

    if not torch.cuda.is_available():
        raise SystemExit("fused_fps: needs a GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    out = {"tree": tree, "card": card, "games": {}}
    for name, run, frames in (("cube_slider", cube_slider.run_fused, 60),
                              ("tycoon", tycoon.run_fused, 60),
                              ("fluid", fluid.run_fused, 30)):
        out["games"][name] = [run(n_frames=frames)[1]
                              for _ in range(args.reps)]
    sc = build_bench_scene(1920, 1080, target_tris=1_000_000)
    sc.set_performance_preset("balanced")
    ms = []
    for k in range(11):
        a = math.radians(0.5 * k)
        sc.set_camera((7.5 * math.sin(a), 1.2, 6.0 - 7.5 * math.cos(a)),
                      (0.0, 0.0, 6.0), fov=60)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sc.render_frame()
        ms.append(1e3 * (time.perf_counter() - t0))
    out["balanced_1080p_ms"] = ms[1:]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
