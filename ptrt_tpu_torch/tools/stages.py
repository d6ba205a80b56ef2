"""The à-trous passes and the K3 shading stages, timed pass by pass and
bounce by bounce on the card, for this tree or another one.

``chip_smoke.py`` uses the helpers here (``atrous_taps``, ``shade_bytes``,
``time_atrous``, ``clones_ms``, ``kernel_ms``, ``kernel_resources``).  Run
as a script on a GPU, this file measures one tree's kernels:

    python3 ptrt_tpu_torch/tools/stages.py [--tree DIR] [--out DIR]

``--tree DIR`` measures the checkout in ``DIR`` (an older commit unpacked
with ``git archive``, say) in a process of its own that imports that tree's
package; this file uses only what the port's wrappers have offered since
the K3 kernels were written, so it drives either tree, and the bounds are
this file's for both.  ``--out DIR`` also appends the log to
``DIR/stages.log``.

On the 1920x1080 bench scene (~1M triangles) it prints:

* each kernel's registers, stack and shared bytes (``cuobjdump
  --dump-resource-usage``), its static SASS instruction count by class
  (``cuobjdump -sass``; the à-trous tap loop is unrolled, so its count is
  close to the instructions a surface pixel runs);
* ``svgf_atrous`` at each of the seven passes a balanced frame runs (diffuse
  settings at steps 1, 2, 4, 8, 16, specular at 1, 2, each fed the pass
  before it), held to the plain version, with each pass's own bound;
* ``shade_nee`` and ``shade_scatter`` on the wavefront of each bounce 0-3
  of sample 0, unsplit (the bench path) and split (the balanced path): a
  wrapper call (CUDA events), the calls queued behind a spin of the card
  (CUDA events around launches back to back: device time), and the kernel
  alone (torch.profiler), with the bytes that wavefront must move.

The card's name and power limit lead the output; the last line is JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

# the card's peaks for a kernel's bound (NVIDIA's H100 SXM data sheet, at
# its 700 W limit): device memory, and float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
W, H, TRIS, DEPTH = 1920, 1080, 1_000_000, 4
ATROUS_PASSES = (("diffuse", (1, 2, 4, 8, 16)), ("specular", (1, 2)))
# svgf.cu a-trous, a pixel: the centre's luminance and edge-stopping scale
# 14 and the normalisation 7, and per tap inside the image 21: the kernel
# weight 1, the luminance difference 7, its exp weight 3, the tap weight 1,
# the colour sum 6, the variance sum 2, the weight sum 1 (the edge tests
# short-circuit)
ATROUS_OPS_PIXEL, ATROUS_OPS_TAP = 21, 21
SHADE_NEE_OPS_LANE = 22  # the hit record's normal, facing test and point
SPIN_CYCLES = 20_000_000  # ~11 ms: the host enqueues ten calls meanwhile


def atrous_taps(h: int, w: int, step: int) -> int:
    """Taps an a-trous pass of ``step`` reads inside an (h, w) image: per
    axis, the pixels whose tap at each of the offsets -2..2 lies inside."""
    axis = lambda n: sum(max(0, n - abs(o) * step) for o in range(-2, 3))
    return axis(h) * axis(w)


def bound(nbytes: float, ops: float = 0.0) -> dict:
    """The least time the card could take: bytes moved (each input read
    once, each output written once) over the memory rate, or operations
    over the float32 rate, whichever is larger."""
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * ops / FP32_OPS_PER_S
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def atrous_bound(h: int, w: int, step: int) -> dict:
    """An a-trous pass reads 9 planes and writes 4 (f32 or int32)."""
    return bound(13 * 4 * h * w, ATROUS_OPS_PIXEL * h * w
                 + ATROUS_OPS_TAP * atrous_taps(h, w, step))


def shade_bytes(stage, pre, post, rec, k1=None, first=False) -> int:
    """Bytes a K3 stage must move on these inputs, from the state before
    (``pre``) and after (``post``) it and the NEE record: each plane read
    once and written once on the lanes that need it.  Every lane reads its
    alive flag and moves its PCG state; a dead lane needs nothing else but
    its hit and NEE flags and shadow t_max; a live lane that misses needs
    only K1's slot, its direction and throughput for the sky term;
    accumulators move only where a term is added, the throughput where it
    changes; the shadow record only on lanes with NEE.  The tables (a few
    KB) are left out."""
    n, split = pre.alive.numel(), pre.split
    cnt = lambda m: int(m.sum())
    changed = lambda a, b: (a.x != b.x) | (a.y != b.y) | (a.z != b.z)
    # accum and the one split channel a term feeds, each read and written
    b = cnt(changed(post.accum, pre.accum)) * 24 * (2 if split else 1)
    nee = rec.shadow_t is not None
    live = pre.alive
    if stage == "shade_nee":
        hit = live & (k1.slot >= 0)
        miss = live & ~hit
        b += n * 3 + (n * 16 if nee else 0)  # alive, hit, do_nee; PCG state
        b += cnt(live) * (4 + 12 + 12)  # K1's slot, direction, throughput
        # the lane dies; which split channel takes the sky term
        b += cnt(miss) * (1 + (1 if split else 0))
        # K1's t and mesh, origin, the two flags; triangle edges; point,
        # normal, front
        b += cnt(hit) * (8 + 12 + 2 + 24 + 25)
        b += cnt(changed(post.throughput, pre.throughput)) * 12
        if first:
            b += n * 28  # the G-buffer
        if nee:  # every t_max; origin, L, pdf, contribution where NEE
            b += n * 4 + cnt(rec.do_nee) * (40 + (12 if split else 0))
        return b
    after = post.alive
    b += n * (1 + 16)  # alive, PCG state
    # material id, normal, front, direction, throughput, alive, flags
    b += cnt(live) * (4 + 12 + 1 + 12 + 12 + 1 + 2)
    if nee:  # NEE flag and pdf; occlusion, L and contribution where lit
        lit = rec.do_nee & live
        b += cnt(lit) * 5 + cnt(lit & (rec.pdf > 0)) * (
            1 + 12 + (24 if split else 12))
    # hit point read; throughput, origin, direction, ray flag written
    return b + cnt(after) * (12 + 12 + 12 + 12 + 1)


def kernel_ms(fn, states, kernel):
    """Mean device ms of ``kernel``'s launches in ``fn(state)`` over fresh
    copies of the state, as torch.profiler records them (the kernel alone,
    without the wrapper's host work between launches); None where the
    profiler does not see every launch."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn(states[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for s in states[1:]:
            fn(s)
        torch.cuda.synchronize()
    ev = [e.time_range.elapsed_us() for e in prof.events()
          if getattr(e, "device_type", None) == DeviceType.CUDA
          and kernel in e.name]
    if len(ev) != len(states) - 1:
        say(f"  (the profiler saw {len(ev)} of {len(states) - 1} {kernel} "
            f"launches: its device time is not measured)")
        return None
    return sum(ev) / 1e3 / len(ev)


def clones_ms(fn, states, spin_cycles: int = 0) -> float:
    """Mean ms of a call ``fn(state)`` over fresh copies of the state (the
    stages update it in place), CUDA events around the whole run.  With
    ``spin_cycles`` the card first spins that long, so the host enqueues
    every call meanwhile and the events time the launches back to back: the
    device's time, where a call's host work outlasts its kernel."""
    import torch

    fn(states[0])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if spin_cycles:
        torch.cuda._sleep(spin_cycles)
    start.record()
    for s in states[1:]:
        fn(s)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (len(states) - 1)


# -- what was compiled ---------------------------------------------------------

_SASS_CLASSES = (("global_load", r"LDG"), ("global_store", r"STG"),
                 ("shared_load", r"LDS"), ("shared_store", r"STS"),
                 ("local", r"LDL|STL"), ("mufu", r"MUFU"),
                 ("float", r"F(ADD|MUL|FMA|MNMX|SETP|SEL|CHK)"),
                 ("branch", r"BRA|BSSY|BSYNC|CALL|RET|EXIT|BAR"))


def kernel_resources(lib_path: str, names) -> dict:
    """{kernel: registers, stack and static shared bytes, SASS instruction
    counts} of the kernels whose (mangled) name holds one of ``names``,
    read from the built library with ``cuobjdump``."""
    from ptrt_tpu_torch import kernels

    tool = os.path.join(os.path.dirname(kernels.nvcc_path()), "cuobjdump")
    run = lambda *a: subprocess.run([tool, *a, lib_path], capture_output=True,
                                    text=True, check=True, timeout=600).stdout
    key = lambda fn: next((n for n in names if n in fn), None)
    out, fn = {}, None
    for line in run("--dump-resource-usage").splitlines():
        m = re.search(r"Function (\S+?):", line)
        if m:
            fn = m.group(1)
        m = re.search(r"REG:(\d+) STACK:(\d+) SHARED:(\d+) LOCAL:(\d+)", line)
        if m and fn and key(fn):
            out.setdefault(key(fn), {})[fn] = {
                "registers": int(m.group(1)), "stack_bytes": int(m.group(2)),
                "shared_bytes": int(m.group(3)),
                "local_bytes": int(m.group(4)), "sass": {}}
    fn = None
    for line in run("-sass").splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)",
                     line)
        if m and fn and key(fn) and fn in out[key(fn)]:
            sass = out[key(fn)][fn]["sass"]
            sass["all"] = sass.get("all", 0) + 1
            for cls, pat in _SASS_CLASSES:
                if re.match(pat, m.group(1)):
                    sass[cls] = sass.get(cls, 0) + 1
    return out


# -- the a-trous passes --------------------------------------------------------


def atrous_inputs(sc, frames: int = 3):
    """Render ``frames`` balanced frames with the camera orbiting, then the
    a-trous inputs of each channel of the last one, as ``denoise_channel``
    builds them: {channel: (settings, image, variance, depth, normal, id)}."""
    import math

    from ptrt_tpu_torch.render import denoiser as den
    from ptrt_tpu_torch.render.motion import motion_vectors

    sc.set_performance_preset("balanced")
    sc.perf.samples_per_pixel = 1
    for k in range(frames):
        a = math.radians(0.5 * k)
        if k == frames - 1:
            state0, prev_vp = sc._denoiser_state, sc.prev_view_proj
        sc.set_camera((7.5 * math.sin(a), 1.2, 6.0 - 7.5 * math.cos(a)),
                      (0.0, 0.0, 6.0), fov=60)
        sc.render_frame()
    bufs, cfg = sc.last_frame, den.DEFAULT_SETTINGS
    rh, rw = bufs.depth.shape
    mvx, mvy = motion_vectors(bufs.depth, sc.camera, prev_vp, rw, rh)
    g = (bufs.depth, bufs.normal, bufs.object_id)
    out = {}
    for name, ch, cap in (
            ("diffuse", cfg.diffuse, None),
            ("specular", cfg.specular, den.specular_history_cap(
                bufs.roughness, bufs.transmission, cfg))):
        src = den.firefly_suppression(getattr(bufs, name), bufs.depth,
                                      bufs.normal, ch.firefly_threshold,
                                      cfg.sky_depth_threshold)
        hist = den.temporal_accumulation(
            src, getattr(state0, name), mvx, mvy, *g, state0, ch, cfg,
            hist_cap=cap, first=state0.first_frame)
        out[name] = (ch, hist.mean, den.estimate_variance(hist, *g, cfg), *g)
    return out


def time_atrous(inputs, iters: int = 20, plain_iters: int = 0) -> list:
    """Each of the seven a-trous passes of a balanced frame: the kernel held
    to the plain version (exact: every value equal or both NaN), timed with
    CUDA events, beside the pass's own bound.  Returns one row a pass."""
    import torch

    from ptrt_tpu_torch.render import denoiser as den
    from ptrt_tpu_torch.tools import cuda_ms

    cfg = den.DEFAULT_SETTINGS
    rows = []
    for name, steps in ATROUS_PASSES:
        ch, img, var, depth, normal, obj = inputs[name]
        h, w = depth.shape
        sky = float(((depth > cfg.sky_depth_threshold)
                     | (normal.dot(normal) < 0.1)).float().mean())
        for step in steps:
            a = (img, var, depth, normal, obj, step, ch, cfg)
            got, want = den.atrous_iteration(*a), den.atrous_iteration_plain(*a)
            same = lambda x, y: bool(((x == y) | (x.isnan() & y.isnan())).all())
            exact = (all(same(x, y) for x, y in zip(
                (got[0].x, got[0].y, got[0].z), (want[0].x, want[0].y,
                                                 want[0].z)))
                and same(got[1], want[1]))
            err = max(float((x - y).abs().nan_to_num().max()) for x, y in (
                (got[0].x, want[0].x), (got[0].y, want[0].y),
                (got[0].z, want[0].z), (got[1], want[1])))
            row = {"channel": name, "step": step, "exact": exact,
                   "max_abs_err": err, "sky_share": sky,
                   "ms": cuda_ms(lambda: den.atrous_iteration(*a), iters),
                   **atrous_bound(h, w, step)}
            if plain_iters:
                row["plain_ms"] = cuda_ms(
                    lambda: den.atrous_iteration_plain(*a), plain_iters)
            rows.append(row)
            img, var = got
    return rows


# -- the shading stages --------------------------------------------------------


def time_shading(sc, split: bool, depth: int = DEPTH,
                 clones: int = 11) -> list:
    """``shade_nee`` and ``shade_scatter`` on the wavefront of each bounce
    of sample 0 of ``sc``'s camera, as ``trace_path`` runs them (K1 through
    the alive plane, the kernels' own state and record carried on): a
    wrapper call (CUDA events) and the kernel alone (profiler) over fresh
    copies of the state, and the bytes the wavefront must move, counted
    from the plain stages run on a copy.  Returns one row a bounce."""
    import torch

    from ptrt_tpu_torch.render import pipeline, shade, traverse

    sc._ensure_device_state()
    g, mats, lights = sc._geom, sc._mat_table, sc._light_table
    n_lights, sky = len(sc.lights), sc.sky()
    rr = int(sc.perf.russian_roulette_start_bounce)
    st, ray = pipeline.camera_rays(sc.camera, sc._rng_state, 0, 0,
                                   sc._blue_noise)
    ps = shade.PathState.start(ray, st, split)
    shade.check_state(ps, mats)

    def fresh(state):  # checked once, as trace_path does
        out = [state.clone() for _ in range(clones)]
        for s in out:
            shade.check_state(s, mats)
        return out

    rows = []
    for bounce in range(depth):
        k1 = traverse.closest_hit_live(g, ps.o, ps.d, ps.alive)
        nee = lambda s: shade.shade_nee(s, g, k1, mats, lights, n_lights,
                                        sky, bounce)
        row = {"split": split, "bounce": bounce, "lanes": ps.alive.numel(),
               "alive": int(ps.alive.sum()), "hit": int((ps.alive & (
                   k1.slot >= 0)).sum())}
        # the plain stages on a copy: the bytes this wavefront needs
        pre, pa = ps.clone(), ps.clone()
        pn = shade.shade_nee_plain(pa, g, k1, mats, lights, n_lights, sky,
                                   bounce)
        row["do_nee"] = int(pn.do_nee.sum())
        times = {"shade_nee": {
            "ms": clones_ms(nee, fresh(ps)),
            "queued_ms": clones_ms(nee, fresh(ps), SPIN_CYCLES),
            "kernel_ms": kernel_ms(nee, fresh(ps), "shade_nee_kernel"),
            **bound(shade_bytes("shade_nee", pre, pa, pn, k1=k1,
                                first=bounce == 0),
                    SHADE_NEE_OPS_LANE * ps.alive.numel())}}
        kn = nee(ps)
        assert torch.equal(ps.rng, pa.rng), f"bounce {bounce}: PCG differs"
        row["flags_equal"] = bool(torch.equal(ps.alive, pa.alive)
                                  and torch.equal(kn.do_nee, pn.do_nee))
        occl = (traverse.any_hit(g, kn.shadow_o, kn.shadow_d, kn.shadow_t)
                if n_lights else None)
        occl_p = (traverse.any_hit(g, pn.shadow_o, pn.shadow_d, pn.shadow_t)
                  if n_lights else None)
        sca = lambda s: shade.shade_scatter(s, kn, occl, mats, bounce, True,
                                            rr)
        before = pa.clone()
        shade.shade_scatter_plain(pa, pn, occl_p, mats, bounce, True, rr)
        times["shade_scatter"] = {
            "ms": clones_ms(sca, fresh(ps)),
            "queued_ms": clones_ms(sca, fresh(ps), SPIN_CYCLES),
            "kernel_ms": kernel_ms(sca, fresh(ps), "shade_scatter_kernel"),
            **bound(shade_bytes("shade_scatter", before, pa, pn))}
        sca(ps)
        assert torch.equal(ps.rng, pa.rng), f"bounce {bounce}: PCG differs"
        row.update(times)
        rows.append(row)
        del pre, pa, pn, before
        torch.cuda.empty_cache()
    return rows


# -- the script ----------------------------------------------------------------


def say(*a) -> None:
    """Print a line and, with ``--out DIR``, append it to
    ``DIR/stages.log`` (a remote run may show only the end of a long
    output)."""
    print(*a, flush=True)
    if say.out:
        os.makedirs(say.out, exist_ok=True)
        with open(os.path.join(say.out, "stages.log"), "a") as fh:
            print(*a, file=fh)


say.out = None


def measure(tag: str, card: str) -> dict:
    """Build the imported tree's kernels and run the measurements."""
    from ptrt_tpu_torch import kernels
    from ptrt_tpu_torch.app.bench_scene import build_bench_scene
    from ptrt_tpu_torch.build import BUILD_DIR

    sc = build_bench_scene(W, H, target_tris=TRIS, device="cuda")
    inputs = atrous_inputs(sc)
    log = lambda *a: say(f"[{tag}]", *a)
    out = {"tag": tag, "card": card, "shading": []}
    out["resources"] = kernel_resources(
        os.path.join(BUILD_DIR, kernels.LIBRARY),
        ("svgf_atrous", "shade_nee", "shade_scatter"))
    for k, fns in out["resources"].items():
        for fn, r in fns.items():
            log(f"{k} {fn[-48:]}: {r['registers']} registers, stack "
                f"{r['stack_bytes']}, static shared {r['shared_bytes']} "
                f"bytes; SASS {r['sass']}")
    for split in (False, True):
        rows = time_shading(sc, split)
        out["shading"] += rows
        for r in rows:
            log(f"split={split} bounce {r['bounce']}: alive {r['alive']}, "
                f"hit {r['hit']}, NEE {r['do_nee']} of {r['lanes']}; "
                + "; ".join(
                    f"{k} call {r[k]['ms']:.4f} queued "
                    f"{r[k]['queued_ms']:.4f} kernel "
                    f"{r[k]['kernel_ms'] or float('nan'):.4f} bound "
                    f"{r[k]['bound_ms']:.4f} ms ({r[k]['bound_by']})"
                    for k in ("shade_nee", "shade_scatter"))
                + f"; flags equal the plain stage's: {r['flags_equal']}"
                f" [{card}]")
        log(f"split={split}, bounces 0-{DEPTH - 1}: " + ", ".join(
            f"{k} kernel {sum(r[k]['kernel_ms'] or 0.0 for r in rows):.4f}"
            f" queued {sum(r[k]['queued_ms'] for r in rows):.4f}"
            f" bound {sum(r[k]['bound_ms'] for r in rows):.4f} ms"
            for k in ("shade_nee", "shade_scatter")))
    out["atrous"] = time_atrous(inputs)
    for r in out["atrous"]:
        log(f"svgf_atrous {r['channel']} step {r['step']}: {r['ms']:.4f} "
            f"ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), exact "
            f"{r['exact']} (max |err| {r['max_abs_err']:.3g}), sky share "
            f"{r['sky_share']:.3f} [{card}]")
    log(f"svgf_atrous, the seven passes: "
        f"{sum(r['ms'] for r in out['atrous']):.4f} ms, bound "
        f"{sum(r['bound_ms'] for r in out['atrous']):.4f} ms")
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", help="measure the checkout in this directory")
    ap.add_argument("--out", help="also append the log to DIR/stages.log")
    args = ap.parse_args(argv)
    say.out = args.out and os.path.abspath(args.out)
    here = os.path.abspath(__file__)
    if args.tree:
        # a process of its own, which finds the other tree's package first
        tree = os.path.abspath(args.tree)
        proc = subprocess.Popen(
            [sys.executable, here], cwd=tree, stdout=subprocess.PIPE,
            text=True, env={**os.environ, "PYTHONPATH": tree})
        for line in proc.stdout:  # the log is kept here
            say(line.rstrip("\n"))
        return proc.wait()
    # behind PYTHONPATH, so that a tree named there is the one measured
    sys.path.append(os.path.dirname(os.path.dirname(os.path.dirname(here))))
    import torch

    import ptrt_tpu_torch

    if not torch.cuda.is_available():
        raise SystemExit("stages: needs a GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    say(card)
    tag = os.path.basename(os.path.dirname(os.path.dirname(
        os.path.abspath(ptrt_tpu_torch.__file__))))
    say(json.dumps(measure(tag, card)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
