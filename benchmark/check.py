"""What decides ``correct``: the timed path's own outputs at one frame of
the window, drawn from the seed, held to the plain reference
(``reference/``), which runs after the window once the program is freed.

During the window the harness copies, at the checked frame only, what the
program produced and carried there into pinned host memory, on the
frame's stream: before the frame, the SVGF history it starts from; after
it, its trace buffers, ray count and history; at its present, its RGB8.
After the window:

* the trace, from scratch: the reference traces a sample of the frame's
  pixels drawn from the seed (their PCG states worked out from their
  coordinates and the frames rendered before, their rays walked over the
  reference's own triangle table, shaded, summed).  Compared:
  ``trace_bad_pct``, the share of sampled pixels whose colour or split
  channels differ by more than 1e-3 + 1e-3 of the reference's value;
  ``gbuf_bad_pct``, the share whose first hit (object id, depth,
  normal, roughness, transmission) differs beyond 1e-4 relative;
  ``rays_err_pct``, the frame's ``rays_traced`` against the sampled
  pixels' mean ray count times the frame's pixels.
* the post stack, step by step from the program's own state: the
  reference's post stack over the program's trace buffers and the history
  the frame started from, its motion vectors against the view-projection
  of the traffic's previous camera (worked out by the reference, not
  taken from the program).  Compared: ``rgb8_diff_pct``, the share of the
  frame's RGB8 values that differ; with the denoiser, ``history_err``,
  the largest gap between the history the frame left and the
  reference's, over the largest value of its plane, and
  ``history_restarted`` (exact, limit 0): the history the frame started
  from has to be carried, not restarted, so this is 1 where it is marked
  as a first frame or where no pixel's history has grown to half of what
  the frames before allow.

Each number has a limit in ``limits/<cell>.json``; ``correct`` is every
number at or under its limit.  The control (``control=True``, never in a
benchmark run) also reads the same numbers with the reference computed
with every stored plane in bfloat16 in the program's place."""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import numpy as np
import torch


def leaves(obj, prefix: str = "") -> dict:
    """{dotted path: tensor} of a tree of tensors, Vec3s (anything with
    x, y, z), named tuples and dataclasses; None leaves are left out."""
    out = {}
    if obj is None:
        return out
    if torch.is_tensor(obj):
        out[prefix] = obj
        return out
    pre = prefix + "." if prefix else ""
    if all(hasattr(obj, c) for c in "xyz") and not hasattr(obj, "_fields"):
        for c in "xyz":
            out.update(leaves(getattr(obj, c), pre + c))
    elif hasattr(obj, "_fields"):
        for f in obj._fields:
            out.update(leaves(getattr(obj, f), pre + f))
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            out.update(leaves(getattr(obj, f.name), pre + f.name))
    else:
        raise TypeError(f"{prefix}: cannot take the leaves of a "
                        f"{type(obj).__name__}")
    return out


class Capture:
    """The checked frame's outputs and carried state, copied on the frame's
    stream into host buffers allocated once (pinned on the card)."""

    def __init__(self, frame: int):
        self.frame = frame  # the window frame to copy
        self.host = {}
        self.rgb8 = None
        self.meta = {}

    def _copy(self, group: str, tree) -> None:
        for name, t in leaves(tree).items():
            key = f"{group}:{name}"
            buf = self.host.get(key)
            if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
                buf = torch.empty(t.shape, dtype=t.dtype,
                                  pin_memory=t.is_cuda)
                self.host[key] = buf
            buf.copy_(t, non_blocking=True)

    def allocate(self, sc) -> None:
        """Allocate the host buffers (in set-up): copy the groups once."""
        self.before(sc)
        self.after(sc)

    def before(self, sc) -> None:
        self._copy("hist0", sc._denoiser_state)

    def after(self, sc) -> None:
        self._copy("bufs", sc.last_frame)
        self._copy("hist1", sc._denoiser_state)

    def group(self, group: str, device) -> dict:
        n = len(group) + 1
        return {k[n:]: v.to(device) for k, v in self.host.items()
                if k.startswith(group + ":")}


def _vec(planes: dict, name: str):
    from benchmark.reference.vec import Vec3

    if name + ".x" not in planes:
        return planes.get(name)
    return Vec3(planes[name + ".x"], planes[name + ".y"], planes[name + ".z"])


def _history(planes: dict):
    from benchmark.reference.denoiser import ChannelHistory, DenoiserState

    ch = lambda c: ChannelHistory(_vec(planes, c + ".mean"),
                                  _vec(planes, c + ".m2"),
                                  planes[c + ".length"])
    return DenoiserState(ch("diffuse"), ch("specular"),
                         _vec(planes, "normal"), planes["depth"],
                         planes["object_id"], planes["first_frame"])


BUFFER_PLANES = ("color", "diffuse", "specular", "emission", "normal",
                 "depth", "object_id", "roughness", "transmission")


def _differs(a, b, rtol: float, atol: float) -> torch.Tensor:
    """Per lane: whether ``a`` differs from the reference ``b`` by more
    than ``atol + rtol * |b|`` (a NaN on either side differs unless both
    are NaN)."""
    gap = (a - b).abs() > atol + rtol * b.abs()
    nan = a.isnan() != b.isnan()
    return gap | nan


def _pct(mask: torch.Tensor) -> float:
    return 100.0 * float(mask.float().mean())


def _vec_differs(a, b, rtol, atol):
    return (_differs(a.x, b.x, rtol, atol) | _differs(a.y, b.y, rtol, atol)
            | _differs(a.z, b.z, rtol, atol))


def trace_numbers(prog: SimpleNamespace, ref: SimpleNamespace, split: bool,
                  rays: int, pixels: int) -> dict:
    """The trace's numbers of the sampled pixels: ``prog`` the program's
    planes there, ``ref`` the reference's, ``rays`` the program's count
    of the frame, ``pixels`` the frame's."""
    bad = _vec_differs(prog.color, ref.color, 1e-3, 1e-3)
    if split:
        for c in ("diffuse", "specular", "emission"):
            bad = bad | _vec_differs(getattr(prog, c), getattr(ref, c), 1e-3,
                                     1e-3)
    g = prog.object_id != ref.object_id
    g = g | _differs(prog.depth, ref.depth, 1e-4, 1e-6)
    g = g | _vec_differs(prog.normal, ref.normal, 1e-4, 1e-6)
    g = g | _differs(prog.roughness, ref.roughness, 1e-4, 1e-6)
    g = g | _differs(prog.transmission, ref.transmission, 1e-4, 1e-6)
    est = float(ref.rays.double().mean()) * pixels
    return {"trace_bad_pct": _pct(bad), "gbuf_bad_pct": _pct(g),
            "rays_err_pct": 100.0 * abs(rays - est) / est}


def history_restarted(hist, frames_before: int) -> float:
    """1 where the history ``hist`` the checked frame starts from was not
    carried: marked as a first frame, or no surface pixel (not sky by the
    denoiser's own test) with a diffuse history of half the frames it can
    have (``min(max_history, frames_before) / 2``); else 0."""
    from benchmark.reference.denoiser import (DEFAULT_SETTINGS,
                                              SKY_DEPTH_THRESHOLD)

    if bool(hist.first_frame):
        return 1.0
    surface = ((hist.depth <= SKY_DEPTH_THRESHOLD)
               & (hist.normal.dot(hist.normal) >= 0.1))
    if not bool(surface.any()):
        return 1.0
    full = min(DEFAULT_SETTINGS.diffuse.max_history, frames_before)
    oldest = float(hist.diffuse.length[surface].max())
    return float(oldest < full / 2)


# history_err where ids or NaNs disagree (a JSON number, unlike inf)
MISMATCH = 1e30


def history_err(got, want) -> float:
    """The largest gap between two histories over the largest value of its
    plane, across their float planes (object ids and the first-frame flag
    must be equal: else ``MISMATCH``)."""
    worst = 0.0
    for name, b in leaves(want).items():
        a = leaves(got)[name]
        if not b.is_floating_point():
            if not torch.equal(a.to(b.dtype), b):
                return MISMATCH
            continue
        scale = max(float(b.abs().max()), 1e-30)
        if bool((a.isnan() != b.isnan()).any()):
            return MISMATCH
        gap = (a - b).abs().nan_to_num(0.0)
        worst = max(worst, float(gap.max()) / scale)
    return worst


def judge(cell, draws, cap: Capture, device, control: bool = False):
    """The numbers that decide ``correct`` for the captured frame,
    {name: value}, and with ``control`` the control's numbers (else
    None)."""
    from benchmark import scenes
    from benchmark.reference import frame

    import sys
    import time

    clock = [time.perf_counter()]

    def lap(what: str) -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        now = time.perf_counter()
        print(f"reference {what}: {now - clock[0]:.2f} s", file=sys.stderr)
        clock[0] = now

    conf, preset = cell.config, cell.traffic["preset"]
    h, w = conf["height"], conf["width"]
    denoise = bool(preset["enable_denoiser"])
    split = denoise
    spp, depth = preset["samples_per_pixel"], preset["max_bounce_depth"]
    rr_start = preset["russian_roulette_start_bounce"]
    ref_sc = scenes.get(conf["scene"]).build_reference(
        conf, draws.scene_seed, device)
    tables = ref_sc.tables(device)
    lap("scene")
    none = (None, None, None)
    camera = ref_sc.camera(device, *(cap.meta["camera"] or none))
    prev_vp = ref_sc.camera(
        device, *(cap.meta["prev_camera"] or none)).get_view_proj()

    p = min(cell.traffic["check"]["pixels"], h * w)
    idx = np.random.default_rng(draws.pixel_seed).choice(h * w, p,
                                                         replace=False)
    idx = torch.from_numpy(np.sort(idx)).to(device)
    ys, xs = idx // w, idx % w
    state = frame.pcg_state(ys, xs, cap.meta["frames_before"])
    trace = lambda rnd: frame.trace_pixels(
        tables, camera, state, cap.meta["frame_index"], ys, xs, (h, w), spp,
        depth, split, True, rr_start, True, rnd=rnd)
    ref = trace(frame.f32)

    lap("trace")
    bufs = cap.group("bufs", device)
    hist0 = _history(cap.group("hist0", device)) if denoise else None
    at = lambda plane: plane[ys, xs]
    planes = {name: _vec(bufs, name) for name in BUFFER_PLANES}
    rgb8 = torch.from_numpy(cap.rgb8).to(device)
    pick = lambda v: (None if v is None else v.map(at)
                      if hasattr(v, "map") else at(v))
    prog = SimpleNamespace(**{k: pick(v) for k, v in planes.items()})
    out = trace_numbers(prog, ref, split, int(bufs["rays_traced"]), h * w)
    lap("inputs")

    post = lambda rnd: frame.post_frame(
        SimpleNamespace(**planes), camera, prev_vp, hist0, denoise,
        bool(preset["enable_motion_vectors"]),
        bool(preset["enable_bloom"]), rnd=rnd)
    ref_rgb8, ref_hist = post(frame.f32)
    lap("post")
    hist1 = _history(cap.group("hist1", device)) if denoise else None
    out["rgb8_diff_pct"] = _pct(rgb8 != ref_rgb8)
    if denoise:
        out["history_err"] = history_err(hist1, ref_hist)
        out["history_restarted"] = history_restarted(
            hist0, cap.meta["frames_before"])
    if not control:
        return out, None
    # the control: the reference with every stored plane in bfloat16, in
    # the program's place
    low = trace(frame.bf16)
    rays = int(round(float(low.rays.double().mean()) * h * w))
    ctl = trace_numbers(low, ref, split, rays, h * w)
    low_rgb8, low_hist = post(frame.bf16)
    ctl["rgb8_diff_pct"] = _pct(low_rgb8 != ref_rgb8)
    if denoise:
        ctl["history_err"] = history_err(low_hist, ref_hist)
        # the control starts from the program's history as the reference
        # does: it cannot move this number
        ctl["history_restarted"] = out["history_restarted"]
    return out, ctl


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]): every number at or under its
    limit; a number without a limit, or a limit without a number, is not
    correct."""
    rows = []
    ok = set(numbers) == set(limits)
    for name in sorted(set(numbers) | set(limits)):
        v, lim = numbers.get(name), limits.get(name)
        rows.append((name, v, lim))
        ok = ok and v is not None and lim is not None and v <= lim
    return ok, rows
