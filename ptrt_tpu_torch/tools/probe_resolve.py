"""K10 rt_resolve on the 1080p "rt" frame, for this tree or another one.

    python3 ptrt_tpu_torch/tools/probe_resolve.py [--tree DIR] [--sweep]

Builds ``build_rt_bench_scene(1920, 1080, 1_000_000)`` on the card with the
package of DIR (this checkout without ``--tree``), renders a frame and
prints one JSON line: the RGB8 SHA-256, whether ``rt_resolve`` equals
``rt_resolve_plain`` and the frame on every pixel, the glass lanes, the
wrapper call queued behind a spin (three readings), its kernels' device
time by the profiler (20 calls) and the K10 kernels' registers and blocks
a SM.  With ``--sweep`` (a tree with ``rt_shading.encode_lut``) also the
encode pass alone queued, and its table against the plain encode on all
2^32 float32 bit patterns, through the kernel and through the table's
plain reader.  Run it on two trees in turns (a ``git archive`` of the
parent, or a copy with a ``constexpr`` changed) to compare them.
"""

import argparse
import hashlib
import json
import os
import sys
import time


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", help="measure the checkout in this directory")
    ap.add_argument("--sweep", action="store_true",
                    help="also hold the encode table on all 2^32 floats")
    args = ap.parse_args(argv)
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    tree = os.path.abspath(args.tree or here)
    sys.path.insert(0, tree)
    import torch

    from ptrt_tpu_torch.app.bench_scene import build_rt_bench_scene
    from ptrt_tpu_torch.core.vec import Vec3
    from ptrt_tpu_torch.render import rt_shading as rs
    from ptrt_tpu_torch.tools import stages

    assert os.path.abspath(rs.__file__).startswith(tree + os.sep), tree
    if not torch.cuda.is_available():
        raise SystemExit("probe_resolve: needs a GPU")
    h, w = 1080, 1920
    sc = build_rt_bench_scene(w, h, 1_000_000, device="cuda")
    sc.render_frame_device()
    img = sc.render_frame_device()
    fr, d = sc.last_frame, sc.camera_rays()[1]
    args_ = (fr.color, fr.hit, d, sc._mat_table, fr.glass, fr.sec_color,
             fr.sec_k1, h, w)
    got = rs.rt_resolve(*args_)
    call = lambda _: rs.rt_resolve(*args_)
    by = {}
    for name, us in stages.profiled_kernels(
            lambda: [call(None) for _ in range(20)],
            lead_cycles=stages.SPIN_CYCLES):
        if "rt_resolve" in name:
            by.setdefault(name.split("(")[0][-40:], []).append(us)
    out = {"tree": tree,
           "sha256": hashlib.sha256(img.cpu().numpy().tobytes()).hexdigest(),
           "equal_plain": bool(torch.equal(got, rs.rt_resolve_plain(*args_))),
           "equal_frame": bool(torch.equal(got, img)),
           "glass_lanes": int(fr.glass.lanes.shape[0]),
           "queued_ms": [stages.clones_ms(call, [None] * 21,
                                          stages.SPIN_CYCLES)
                         for _ in range(3)],
           "profiler_us": {k: sum(v) / len(v) for k, v in by.items()},
           "info": rs.kernel_info(sc._mat_table, sc._light_table,
                                  len(sc.lights))}
    print(json.dumps(out), flush=True)
    if not args.sweep:
        return 0
    nog = (fr.color,) + (None,) * 6 + (h, w)
    sweep = {"encode_queued_ms": [stages.clones_ms(
        lambda _: rs.rt_resolve(*nog), [None] * 21, stages.SPIN_CYCLES)
        for _ in range(2)]}
    del sc, fr, d, args_, got, img
    torch.cuda.empty_cache()
    t0 = time.time()
    lut = rs.encode_lut("cuda")
    hw = 1 << 14
    bad = bad_r = 0
    for lo in range(-(1 << 31), 1 << 31, hw * hw):
        c = torch.arange(lo, lo + hw * hw, dtype=torch.int64,
                         device="cuda").to(torch.int32).view(torch.float32)
        col = Vec3(c, c, c)
        k = rs.rt_resolve(col, *(None,) * 6, hw, hw)
        bad += int((k != rs.rt_resolve_plain(col, *(None,) * 6, hw, hw))
                   .any(-1).sum())
        bad_r += int((rs.encode_lut_plain(c, lut) != rs.encode_plain(c))
                     .sum())
        del c, col, k
    sweep.update({"colours_off": bad, "r_values_off": bad_r,
                  "s": time.time() - t0})
    print(json.dumps(sweep), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
