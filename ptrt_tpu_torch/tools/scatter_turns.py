"""``shade_scatter`` at bounces 0-3 and K12 at the main path's four shapes,
queued on the card, for one tree; run trees in turns to compare a kernel's
variants or a parent commit on one card.

    PYTHONPATH=TREE python3 ptrt_tpu_torch/tools/scatter_turns.py TAG

imports the ``ptrt_tpu_torch`` of TREE (this checkout, a ``git archive``d
parent, or a copy of ``ptrt_tpu_torch/`` with a kernel source edited, in a
git-ignored directory of the checkout), builds its kernels, and times
``shade_scatter`` on
the wavefronts of bounces 0-3 of sample 0 of the 1080p bench scene
(unsplit) and the "hdri" scene (split), as the trace's loop runs it (with
the ray count where the tree's ``shade_scatter`` takes it), three readings
a bounce of 20 calls queued behind a spin over fresh copies of the state;
and ``upscale_bilinear`` at 224x125 -> 640x360, 112x62 -> 320x180,
672x378 -> 1920x1080 and 1440x810 -> 1920x1080 on seeded planes, three
readings, with the sums of its output's values and bits (two trees' outputs
compare bit for bit).  Prints one line ``RESULT {json}``.
"""

import inspect
import json
import sys

import numpy as np
import torch

# K12's shapes on the main path (the games' "fast" frames, the scenes'
# "fast" and "performance" frames): (in_h, in_w), (out_h, out_w)
UPSCALES = (((125, 224), (360, 640)), ((62, 112), (180, 320)),
            ((378, 672), (1080, 1920)), ((810, 1440), (1080, 1920)))


def scatter_ms(sc, split: bool, reps: int = 21) -> list:
    """Three queued readings of ``shade_scatter`` at each bounce 0-3."""
    from ptrt_tpu_torch.render import pipeline, shade, traverse
    from ptrt_tpu_torch.tools import stages

    counted = "rays" in inspect.signature(shade.shade_scatter).parameters
    sc._ensure_device_state()
    g, mats, lights = sc._geom, sc._mat_table, sc._light_table
    n_lights, sky = len(sc.lights), sc.sky()
    env = sky.has_env_sampling
    casts = int(env) + int(n_lights > 0)
    sub, ray = pipeline.camera_rays(sc.camera, sc._rng_state, 0, 0,
                                    sc._blue_noise)
    ps = shade.PathState.start(ray, sub, split,
                               **({"env_nee": True} if env else {}))
    rays = torch.zeros((), dtype=torch.int64, device=sub.device)
    rows = []
    for bounce in range(4):
        k1 = traverse.closest_hit_live(g, ps.o, ps.d, ps.alive)
        nee = shade.shade_nee(ps, g, k1, mats, lights, n_lights, sky, bounce)
        kw = {}
        if env:
            kw["env_shadow"] = traverse.any_hit(g, nee.env_o, nee.env_d,
                                                nee.env_t)
        in_sh = traverse.any_hit(g, nee.shadow_o, nee.shadow_d, nee.shadow_t)
        if counted:
            kw.update(rays=rays, casts=casts, next_bounce=bounce < 3,
                      base=ps.alive.numel() if bounce == 0 else 0)
        fn = lambda c: shade.shade_scatter(c, nee, in_sh, mats, bounce, True,
                                           1, **kw)

        def fresh():
            out = [ps.clone() for _ in range(reps)]
            for c in out:
                shade.check_state(c, mats)
            return out
        rows.append([stages.clones_ms(fn, fresh(), stages.SPIN_CYCLES)
                     for _ in range(3)])
        fn(ps)
        torch.cuda.empty_cache()
    return rows


def upscale_ms() -> dict:
    """Three queued readings of K12 at each shape, and its output's sums."""
    from ptrt_tpu_torch.core.vec import Vec3
    from ptrt_tpu_torch.render import pipeline
    from ptrt_tpu_torch.tools import stages

    rng = np.random.default_rng(24)
    out = {}
    for (ih, iw), (oh, ow) in UPSCALES:
        img = Vec3(*[torch.from_numpy(rng.lognormal(-1.0, 1.5, (ih, iw))
                                      .astype(np.float32)).cuda()
                     for _ in range(3)])
        fn = lambda _: pipeline.upscale_bilinear(img, oh, ow)
        o = fn(None)
        out[f"{iw}x{ih}"] = {
            "ms": [stages.clones_ms(fn, [None] * 21, stages.SPIN_CYCLES)
                   for _ in range(3)],
            "sum": sum(float(c.double().sum()) for c in (o.x, o.y, o.z)),
            "bits": sum(int(c.view(torch.int32).long().sum())
                        for c in (o.x, o.y, o.z))}
    return out


def main(argv) -> int:
    from ptrt_tpu_torch import kernels
    from ptrt_tpu_torch.app.bench_scene import (build_bench_scene,
                                                build_hdri_scene)

    if not torch.cuda.is_available():
        raise SystemExit("scatter_turns: needs a GPU")
    kernels.get_lib()
    out = {"tag": argv[0] if argv else "tree",
           "bench": scatter_ms(build_bench_scene(
               1920, 1080, target_tris=1_000_000, device="cuda"), False),
           "hdri": scatter_ms(build_hdri_scene(
               1920, 1080, target_tris=1_000_000, device="cuda"), True),
           "upscale": upscale_ms()}
    print("RESULT " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
