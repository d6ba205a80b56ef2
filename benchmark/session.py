"""One run of one cell: set-up, the measured window, the traced stretch,
the reference's check, the result line.

The window drives ``Scene.render_frame_device`` as
``app/viewer.run_interactive`` does: each loop enqueues frame i (after
moving the camera along the cell's path), starts its RGB8 copy into one
of two pinned host buffers, then waits for frame i-1's copy (its present).
So at most one frame is in flight behind the one being enqueued."""

from __future__ import annotations

import gc
import json
import sys
import time
from types import SimpleNamespace

from benchmark import check, traffic, window

FORBIDDEN = ("jax", "jaxlib", "flax", "ptrt_tpu")


def forbidden_modules() -> list:
    """The modules of ``sys.modules`` whose top-level name is one the
    harness may not load (compared whole: ``ptrt_tpu_torch`` is not
    ``ptrt_tpu``)."""
    return sorted(name for name in list(sys.modules)
                  if name.split(".")[0] in FORBIDDEN)


class HostFrames:
    """The frame's one device-to-host copy, into one of two pinned host
    buffers used in turn, an event recorded after it (a CPU image is its
    own host copy)."""

    def __init__(self):
        self.bufs = [None, None]
        self.turn = 0

    def start(self, img):
        import torch

        if img.device.type != "cuda":
            return img, None
        k, self.turn = self.turn, 1 - self.turn
        buf = self.bufs[k]
        if buf is None or buf.shape != img.shape:
            buf = self.bufs[k] = torch.empty(img.shape, dtype=img.dtype,
                                             pin_memory=True)
        buf.copy_(img, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return buf, done

    @staticmethod
    def finish(started):
        buf, done = started
        if done is not None:
            done.synchronize()
        return buf.numpy()


class Loop:
    """The game loop over the port's scene: ``step()`` is one iteration.
    ``presents`` holds each present's time; ``cap`` copies the checked
    frame."""

    def __init__(self, sc, cell, draws, spans, cap):
        self.clock = time.perf_counter
        self.sc, self.cell, self.draws, self.spans = sc, cell, draws, spans
        self.cap = cap
        self.host = HostFrames()
        self.pending = None  # (frame number, started copy)
        self.frames = 0  # frames enqueued since the scene was built
        self.window_first = None  # the frame number of window frame 0
        self.presents = []  # (frame number, time)
        self.window = []  # the times of the window's presents
        self.window_frames = []  # the window frame each of them shows

    def window_frame(self, n: int):
        return None if self.window_first is None else n - self.window_first

    def step(self) -> None:
        sc, n = self.sc, self.frames
        with self.spans.span("camera.update"):
            cam = traffic.camera_at(self.cell.traffic, self.draws, n)
            if cam is not None:
                lookfrom, lookat, fov = cam
                sc.set_camera(lookfrom, lookat, fov=fov)
            # a game's set_camera restarts the jitter counter; the cell
            # moves it on one a frame from the seed's start
            sc.frame_count = self.draws.first_index + n
        checked = self.window_frame(n) == self.cap.frame
        if checked:
            self.cap.before(sc)
            self.cap.meta.update(
                frame_index=sc.frame_count, frames_before=n, camera=cam,
                prev_camera=traffic.camera_at(self.cell.traffic,
                                              self.draws, n - 1))
        with self.spans.span("frame.enqueue"):
            img = sc.render_frame_device()
        if checked:
            self.cap.after(sc)
        with self.spans.span("frame.copy"):
            started = self.host.start(img)
        if self.pending is not None:
            m, prev = self.pending
            with self.spans.span("frame.present_wait"):
                host = self.host.finish(prev)
            now = self.clock()
            self.presents.append((m, now))
            if self.window_frame(m) is not None and self.window_frame(m) >= 0:
                self.window.append(now)
                self.window_frames.append(self.window_frame(m))
            if self.window_frame(m) == self.cap.frame:
                self.cap.rgb8 = host.copy()
        self.pending = (n, started)
        self.frames += 1

    def drain(self) -> None:
        """Wait for the frame in flight (not presented in a window)."""
        if self.pending is not None:
            self.host.finish(self.pending[1])
            self.pending = None


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, control: bool = False) -> dict:
    """One run of ``cell``; returns the result line as a dict.  ``t_start``
    is the process's start on ``time.perf_counter``'s clock."""
    import torch

    device = torch.device(device)
    on_card = device.type == "cuda"
    spans = window.Spans()
    # the process so far: the interpreter's imports (numpy, torch) and the
    # card's probe
    spans.spans.append(("setup.python", t_start, time.perf_counter()))
    draws = traffic.draws(cell.traffic, seed)
    with spans.span("setup.cuda"):
        if on_card:
            torch.cuda.init()
            torch.cuda.reset_peak_memory_stats(device)
    with spans.span("setup.import"):
        from ptrt_tpu_torch import kernels
        from benchmark import scenes
    with spans.span("setup.kernels"):
        if on_card:
            kernels.get_lib()
    with spans.span("setup.scene"):
        sc = scenes.get(cell.config["scene"]).build_program(
            cell.config, draws.scene_seed, device)
        traffic.apply_preset(sc, cell.traffic)
    with spans.span("setup.device_state"):
        sc._ensure_device_state()
        _sync(device)
    cap = check.Capture(draws.check_frame)
    loop = Loop(sc, cell, draws, spans, cap)
    with spans.span("setup.first_frame"):
        loop.step()
        _sync(device)
    profiled_frames = cell.traffic["profiled_frames"]
    with spans.span("setup.warm"):
        for _ in range(cell.traffic["warm_frames"]):
            loop.step()
        loop.drain()
        cap.allocate(sc)
        # each profiled frame's rays_traced, copied on the frame's stream
        rays = (torch.zeros(profiled_frames, dtype=torch.int64,
                            pin_memory=True) if trace and on_card else None)
        _sync(device)

    # the window: from the first present of the loop below
    prof = None
    loop.window_first = loop.frames
    prof_at = cell.traffic["check"]["frame_before"] + 16
    span_names = {"camera.update", "frame.enqueue", "frame.copy",
                  "frame.present_wait"}
    while True:
        if trace and on_card and prof is None \
                and loop.frames - loop.window_first == prof_at:
            from benchmark.trace import profiled

            def step(i):
                spans.profiling = True
                try:
                    loop.step()
                    rays[i].copy_(loop.sc.last_frame.rays_traced,
                                  non_blocking=True)
                finally:
                    spans.profiling = False
            prof = profiled(step, profiled_frames, span_names)
        loop.step()
        pres = loop.window
        if (pres and pres[-1] - pres[0] >= seconds and cap.rgb8 is not None
                and (not (trace and on_card) or prof is not None)):
            break
    loop.drain()
    _sync(device)
    presents = loop.window
    t0, t1 = presents[0], presents[-1]
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    data = SimpleNamespace(
        cell=cell, spans=spans, presents=presents,
        window_spans=[(n, s, e) for n, s, e in spans.spans if t0 <= s <= t1],
        window_frames=loop.window_frames,
        # the presents the profiler slows: the stretch's, the one before
        # and the two after it (the trace is read between them)
        profiled=(range(prof_at - 1, prof_at + profiled_frames + 2)
                  if prof is not None else range(0)),
        peak_bytes=peak, setup_s=t0 - t_start, profile=prof,
        pool_bytes=sum(p.stats["pool_bytes"]
                       for p in sc._programs.values()),
        rays_profiled=None if prof is None else int(rays.sum()),
        render_size=sc.render_size, size=(sc.height, sc.width))
    print("setup spans: " + ", ".join(
        f"{n[6:]} {e - s:.3f} s" for n, s, e in spans.spans
        if n.startswith("setup.")), file=sys.stderr, flush=True)
    # the program's state is freed before the reference runs
    del sc, loop
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    if prof is not None:
        from benchmark.trace import layer_maps

        prof.reduce(layer_maps())
        print("device operations: " + json.dumps(
            sorted({n for n, _, _ in prof.ops})), flush=True)
        if prof.unmapped:
            print("glue_ms takes kernels no layer file maps: "
                  + json.dumps(prof.unmapped), flush=True)
    from benchmark import metrics

    shown = cell.per_layer if trace else cell.end_to_end
    values = {}
    for m in shown:
        v = metrics.read(m["name"], data)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}

    numbers, ctl = check.judge(cell, draws, cap, device, control=control)
    correct, rows = check.verdict(numbers, cell.limits["limits"])
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": (torch.cuda.get_device_name(device) if on_card
                    else "cpu"),
           "count": cell.chips if on_card else 1,
           "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": len(presents) - 1,
           "failed": 0 if correct else 1, "metrics": values, "device": dev}
    if prof is not None:
        dev["busy_s"] = prof.busy_us / 1e6
        dev["window_s"] = prof.window_us / 1e6
        out["breakdown"] = {"device_ops": prof.top,
                            "idle_gaps": prof.idle_gaps}
    if ctl is not None:
        out["control"] = ctl
    out["checked"] = {name: {"value": v, "limit": lim}
                      for name, v, lim in rows}
    return out
