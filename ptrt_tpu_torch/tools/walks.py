"""The BVH walks' wavefronts, and builds of the walks' source compared on the
card.

``wavefronts`` and ``late_bounce`` give the ray sets that the main path
hands K1 and K2 on a scene; ``chip_smoke.py`` checks and times the walks on
them.  Run as a module on a GPU, this file compares sources of the walks
side by side:

    python3 -m ptrt_tpu_torch.tools.walks [NAME=SOURCE ...]

Each argument names a CUDA source with the C interface of
``csrc/traverse.cu`` (a variant of it, say); with no argument, this tree's
``csrc/traverse.cu``.  Every source is compiled with ``-Xptxas -v`` (all
nvcc processes started together) into its own library under the build
directory, and its registers, stack frame and spills are printed.  On the
1920x1080 bench scene (~1M triangles) each build runs, through the port's
own wrappers, the main path's four wavefronts at full width — camera and
bounce 1 rays for K1 on their t_max planes, bounce 3 rays through the alive
plane, and the shadow rays for K2 — timed with CUDA events, build by build,
then again in reverse order; every answer is held to the first build's.
The card's name and power limit lead the output; the last line is JSON.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import os
import re
import subprocess
import sys

import torch

from ptrt_tpu_torch import kernels
from ptrt_tpu_torch.build import BUILD_DIR
from ptrt_tpu_torch.core.vec import where
from ptrt_tpu_torch.render import pipeline, shade, traverse
from ptrt_tpu_torch.tools import cuda_ms

W, H, TRIS = 1920, 1080, 1_000_000
ITERS = 20


def wavefronts(sc):
    """Sample-0 camera rays of the scene, one bounce of scattered rays and
    the NEE shadow rays from the camera hits — the three ray sets the main
    path hands K1 and K2, as flat (R,) tensors: [(name, o, d, t_max)]."""
    from ptrt_tpu_torch.render.bsdf import material_scatter
    from ptrt_tpu_torch.render.nee import sample_light

    sc._ensure_device_state()
    state, ray = pipeline.camera_rays(sc.camera, sc._rng_state, 0, 0,
                                      sc._blue_noise)
    flat = lambda v: v.map(lambda c: c.reshape(-1).contiguous())
    o, d = flat(ray.origin), flat(ray.direction)
    state = state.reshape(-1)
    t_cam = torch.full_like(o.x, traverse.T_MAX)
    hit = traverse.intersect_closest(sc._geom, o, d, t_cam)
    mat = sc._mat_table.gather(hit.mesh_index.clamp_min(0))
    state, sc_res = material_scatter(state, hit.normal, hit.front_face, mat,
                                     d)
    alive = hit.hit & sc_res.valid
    off = where(sc_res.direction.dot(hit.normal) > 0.0, hit.normal * 1e-4,
                hit.normal * -1e-4)
    o_b = flat(where(alive, hit.point + off, o))
    d_b = flat(where(alive, sc_res.direction, d))
    t_b = torch.where(alive, traverse.T_MAX, -1.0).contiguous()
    _, l, _, _, _, dist = sample_light(state, sc._light_table,
                                       len(sc.lights), hit.point)
    off = where(hit.normal.dot(l) > 0.0, hit.normal * 1e-4,
                hit.normal * -1e-4)
    o_s = flat(hit.point + off)
    t_s = torch.where(hit.hit, dist - 1e-3, -1.0).contiguous()
    return [("camera", o, d, t_cam), ("bounce", o_b, d_b, t_b),
            ("shadow", o_s, flat(l), t_s)]


def late_bounce(sc, bounces: int = 3):
    """The rays of bounce ``bounces`` of one sample of the main path:
    ``trace_path``'s loop (K1, ``shade_nee``, K2, ``shade_scatter``) run
    ``bounces`` times on sample 0's camera rays, Russian roulette and all.
    Returns (name, o, d, alive) of the ``PathState`` it leaves."""
    sc._ensure_device_state()
    g, mats = sc._geom, sc._mat_table
    state, ray = pipeline.camera_rays(sc.camera, sc._rng_state, 0, 0,
                                      sc._blue_noise)
    ps = shade.PathState.start(ray, state, False)
    shade.check_state(ps, mats)
    n_lights = len(sc.lights)
    for b in range(bounces):
        k1 = traverse.closest_hit_live(g, ps.o, ps.d, ps.alive)
        nee = shade.shade_nee(ps, g, k1, mats, sc._light_table, n_lights,
                              sc.sky(), b)
        occl = (traverse.any_hit(g, nee.shadow_o, nee.shadow_d, nee.shadow_t)
                if n_lights else None)
        shade.shade_scatter(ps, nee, occl, mats, b, True,
                            sc.perf.russian_roulette_start_bounce)
    return f"bounce {bounces}", ps.o, ps.d, ps.alive


@contextlib.contextmanager
def _walks_from(lib: ctypes.CDLL):
    """Run the walk wrappers on ``lib`` (a build of a walk source) instead
    of the port's library."""
    saved, kernels._lib = kernels._lib, lib
    try:
        yield
    finally:
        kernels._lib = saved


def compile_builds(specs):
    """Compile every (name, source) with its own nvcc, all started together.
    Returns {name: library path} and {name: ptxas report}; a build that
    fails is reported and left out."""
    nvcc = kernels.nvcc_path()
    out_dir = os.path.join(BUILD_DIR, "walk_builds")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, src in specs:
        lib = os.path.join(out_dir, f"lib{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [nvcc, *kernels.NVCC_FLAGS, *kernels.SOURCE_FLAGS["traverse.cu"],
             "-shared", "-Xptxas", "-v", src, "-o", lib],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, reports = {}, {}
    for name, (lib, proc) in procs.items():
        text, _ = proc.communicate(timeout=900)
        if proc.returncode != 0:
            print(f"[nvcc] {name} failed:\n{text}", flush=True)
            continue
        libs[name], reports[name] = lib, ptxas_report(text)
    return libs, reports


def ptxas_report(text: str) -> list[str]:
    """One line per kernel of nvcc's ``-Xptxas -v`` output: its name, then
    its stack frame, spills and registers."""
    lines, name = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        elif name and ("stack frame" in line or "Used" in line):
            lines.append(f"{name}: {line.strip()}")
    return lines


def _disagreement(got, want):
    """(rays that disagree, t within rtol 1e-4 where both hit, identical):
    K2 by its flag, K1 by hit and mesh."""
    if len(want) == 1:
        same, t_ok = got[0] == want[0], True
    else:
        same = ((got[3] >= 0) == (want[3] >= 0)) & (got[4] == want[4])
        both = same & (want[3] >= 0)
        t_ok = bool(((got[0] - want[0]).abs()
                     <= 1e-4 * want[0].abs())[both].all())
    return (int((~same).sum()), t_ok,
            all(torch.equal(x, y) for x, y in zip(got, want)))


def main(argv: list[str]) -> int:
    from ptrt_tpu_torch.app.bench_scene import build_bench_scene

    if not torch.cuda.is_available():
        raise SystemExit("walks: needs a GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    specs = ([tuple(arg.split("=", 1)) for arg in argv]
             or [("this", os.path.join(kernels.CSRC, "traverse.cu"))])
    libs, reports = compile_builds(specs)
    builds = {}
    for name, _ in specs:
        if name in libs:
            print(f"[ptxas] {name}", flush=True)
            for line in reports[name]:
                print(f"  {line}", flush=True)
            builds[name] = kernels.bind_walks(ctypes.CDLL(libs[name]))

    sc = build_bench_scene(W, H, target_tris=TRIS, device="cuda")
    rays = wavefronts(sc)
    g = sc._geom
    runs, live = {}, {}
    for name, o, d, t in rays:
        if name == "shadow":
            runs[name] = lambda o=o, d=d, t=t: (traverse.any_hit(g, o, d, t),)
        else:
            runs[name] = lambda o=o, d=d, t=t: traverse.closest_hit(g, o, d, t)
        live[name] = int((t > 0).sum())
    name3, o3, d3, alive3 = late_bounce(sc, 3)
    runs[name3] = lambda: traverse.closest_hit_live(g, o3, d3, alive3)
    live[name3] = int(alive3.sum())
    print(f"[rays] {W}x{H}: live rays {live}", flush=True)

    answers = {}
    for b, lib in builds.items():
        with _walks_from(lib):
            answers[b] = {w: tuple(run()) for w, run in runs.items()}
    first = answers[next(iter(builds))]
    times = {}
    for order in (list(builds), list(builds)[::-1]):
        for b in order:
            with _walks_from(builds[b]):
                for w, run in runs.items():
                    times.setdefault((b, w), []).append(cuda_ms(run, ITERS))
    result = []
    for b in builds:
        row = {"build": b}
        for w in runs:
            mism, t_ok, exact = _disagreement(answers[b][w], first[w])
            row[w] = {"ms": times[(b, w)], "mismatches": mism, "t_ok": t_ok,
                      "exact": exact}
        result.append(row)
        print(f"[time] {b}: " + "; ".join(
            f"{w} {'/'.join(f'{x:.4f}' for x in row[w]['ms'])} ms "
            f"({row[w]['mismatches']} mismatches, t ok {row[w]['t_ok']}, "
            f"identical {row[w]['exact']})" for w in runs)
              + f" [{card}]", flush=True)
    print(json.dumps({"card": card, "live": live, "builds": result}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
