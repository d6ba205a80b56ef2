"""Multi-device pixel tiles: the frame's trace split over a grid of devices.

Counterpart of ``ptrt_tpu/parallel/sharding.py``.  The reference shards the
(H, W) pixel grid over a 2-D ``jax.sharding.Mesh`` and lets ``shard_map``
run the trace on each device's tile; the scene tables are replicated, and
the denoiser, bloom and tonemap stay global.  Here a ``PixelMesh`` is a
dy x dx grid of ``torch.device``s, each tile with its own CUDA stream on a
card, and the unit of work is the tiled trace ``pipeline.trace_frame(...,
tile=(y0, x0, full_h, full_w))``, which is bit for bit the whole frame's
pixels.  ``shard_mapped_trace`` enqueues every tile's trace (each on its
own stream, with its own ray counters: one a walk call) before it waits on
any, and sums ``rays_traced`` on the device.  ``gather_pixels`` builds the
whole-frame buffers on the mesh's first device, where the post stack runs.

Devices: ``make_pixel_mesh()`` takes every card.  Past the card count,
tiles share cards round-robin, each tile on its own stream, so one H100
runs n tiles on n streams of ``cuda:0``.  A CPU caller passes a device
list such as ``["cpu"] * 8`` (tiles then run one after another).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import torch

from ptrt_tpu_torch.core.vec import Vec3


@dataclass(frozen=True)
class PixelMesh:
    """A (dy, dx) grid of devices, as square as the count allows; on a card
    each tile has its own stream (None on the CPU)."""

    devices: tuple  # dy tuples of dx torch.device
    streams: tuple  # the same grid of torch.cuda.Stream or None

    @property
    def shape(self) -> tuple:
        return len(self.devices), len(self.devices[0])

    @property
    def size(self) -> int:
        dy, dx = self.shape
        return dy * dx

    @property
    def first_device(self) -> torch.device:
        return self.devices[0][0]

    def tiles(self, rh: int, rw: int) -> list:
        """[(iy, ix, y0, x0, tile_h, tile_w)] of an rh x rw frame, row by
        row; raises ``ValueError`` unless the size divides the mesh."""
        dy, dx = self.shape
        if rh % dy or rw % dx:
            raise ValueError(f"render size {rh}x{rw} must divide the "
                             f"{dy}x{dx} mesh")
        th, tw = rh // dy, rw // dx
        return [(iy, ix, iy * th, ix * tw, th, tw)
                for iy in range(dy) for ix in range(dx)]


@dataclass(frozen=True)
class Sharded:
    """One value a tile of a ``PixelMesh`` (``parts[iy][ix]`` on that
    tile's device): the tile's window of a pixel plane, or with
    ``replicated`` the whole value."""

    parts: tuple
    replicated: bool = False


def make_pixel_mesh(n_devices: int | None = None,
                    devices=None) -> PixelMesh:
    """A pixel mesh of ``n_devices`` tiles (dy the largest divisor of n that
    is at most isqrt(n)).  ``devices``: the tiles' devices in row order
    (the first ``n_devices`` of them); by default the cards, every one of
    ``torch.cuda.device_count()`` or, past it, round-robin.  Without a card
    and without a device list it raises."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_pixel_mesh: no CUDA device; pass a "
                               "device list such as ['cpu'] * 8")
        count = torch.cuda.device_count()
        n = count if n_devices is None else int(n_devices)
        devs = [torch.device("cuda", k % count) for k in range(n)]
    else:
        devs = [torch.device(d) for d in devices]
        if n_devices is not None:
            devs = devs[:n_devices]
    n = len(devs)
    if n < 1:
        raise ValueError("a pixel mesh needs at least one device")
    best = 1
    for dy in range(1, math.isqrt(n) + 1):
        if n % dy == 0:
            best = dy
    dy, dx = best, n // best
    grid = tuple(tuple(devs[iy * dx:(iy + 1) * dx]) for iy in range(dy))
    streams = tuple(tuple(torch.cuda.Stream(device=d) if d.type == "cuda"
                          else None for d in row) for row in grid)
    return PixelMesh(devices=grid, streams=streams)


def _tree_map(fn, tree):
    """``fn`` on every tensor (and ``Sharded``) leaf of a tree of Vec3s,
    tuples, NamedTuples, lists, dicts and dataclasses; other leaves as
    they are."""
    if isinstance(tree, (torch.Tensor, Sharded)):
        return fn(tree)
    if isinstance(tree, Vec3):
        return tree.map(lambda c: _tree_map(fn, c))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_tree_map(fn, v) for v in tree])
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _tree_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    return tree


def _to(tree, device: torch.device):
    """The tree with each tensor on ``device`` (no copy where it is
    already there)."""
    return _tree_map(lambda t: t if t.device == device
                     else t.to(device, non_blocking=True), tree)


def shard_pixels(mesh: PixelMesh, tree):
    """Every (H, W[, ...]) tensor leaf cut into the mesh's tiles (rows over
    y, columns over x), each tile a contiguous copy on its device; leaves
    of rank < 2 replicated.  Raises ``ValueError`` where a plane does not
    divide the mesh."""
    def place(t: torch.Tensor) -> Sharded:
        if t.dim() < 2:
            return _replicate_leaf(mesh, t)
        rows = [[None] * mesh.shape[1] for _ in range(mesh.shape[0])]
        for iy, ix, y0, x0, th, tw in mesh.tiles(t.shape[0], t.shape[1]):
            rows[iy][ix] = t[y0:y0 + th, x0:x0 + tw].to(
                mesh.devices[iy][ix]).contiguous()
        return Sharded(tuple(tuple(r) for r in rows))

    return _tree_map(place, tree)


def _replicate_leaf(mesh: PixelMesh, t: torch.Tensor) -> Sharded:
    copies = {}
    parts = tuple(tuple(copies.setdefault(d, _to(t, d)) for d in row)
                  for row in mesh.devices)
    return Sharded(parts, replicated=True)


def replicate(mesh: PixelMesh, tree):
    """Every tensor leaf as a ``Sharded`` whose tiles each hold the whole
    tensor on their device: one copy a device, none onto a device that
    already holds it."""
    return _tree_map(lambda t: _replicate_leaf(mesh, t), tree)


def gather_pixels(mesh: PixelMesh, tree):
    """Whole-frame values on the mesh's first device: each tiled
    ``Sharded`` leaf put together, a replicated one as its first tile's;
    other leaves as they are."""
    first = mesh.first_device

    def gather(leaf):
        if not isinstance(leaf, Sharded):
            return leaf
        if leaf.replicated:
            return _to(leaf.parts[0][0], first)
        cols = [torch.cat([_to(p, first) for p in row], dim=1)
                for row in leaf.parts]
        return torch.cat(cols, dim=0)

    return _tree_map(gather, tree)


def shard_mapped_trace(mesh: PixelMesh, rh: int, rw: int, trace_tile):
    """A tracer of the rh x rw frame whose every tile runs on its own
    device and stream.

    ``trace_tile(rng_state_local, *args, tile=(y0, x0, rh, rw)) ->
    (rng_state_local, FrameBuffers_local)`` traces one tile with global
    pixel coordinates (``pipeline.trace_frame(..., tile=)``).  The returned
    ``fn(rng_state, *args)`` takes the frame's PCG state (a whole (rh, rw)
    tensor or a ``Sharded`` one) and the scene's tables, replicated to each
    device; it enqueues every tile before it waits on any and returns
    (the next state, FrameBuffers) with each pixel plane ``Sharded`` and
    ``rays_traced`` summed into an int64 tensor on the mesh's first
    device, with no read to the host (``gather_pixels`` puts the planes
    together).  A size that does not divide the mesh raises
    ``ValueError``."""
    tiles = mesh.tiles(rh, rw)
    first = mesh.first_device

    def fn(rng_state, *args):
        local = {}  # the args on each device, copied on its current stream
        for row in mesh.devices:
            for d in row:
                if d not in local:
                    local[d] = _to(args, d)
        outs = {}
        for iy, ix, y0, x0, th, tw in tiles:
            d, s = mesh.devices[iy][ix], mesh.streams[iy][ix]
            part = (rng_state.parts[iy][ix] if isinstance(rng_state, Sharded)
                    else rng_state[y0:y0 + th, x0:x0 + tw])
            if s is None:
                outs[iy, ix] = trace_tile(_to(part, d).contiguous(),
                                          *local[d], tile=(y0, x0, rh, rw))
                continue
            # the tile's stream starts after what its inputs were made by;
            # what it allocates belongs to it
            s.wait_stream(torch.cuda.current_stream(d))
            with torch.cuda.stream(s):
                outs[iy, ix] = trace_tile(_to(part, d).contiguous(),
                                          *local[d], tile=(y0, x0, rh, rw))
        # every tile is enqueued: the devices' current streams (the first
        # device's gathers, the others' frees) now wait for the tiles, and
        # the tiles' outputs stay allocated until those streams used them
        for iy, ix, *_ in tiles:
            s = mesh.streams[iy][ix]
            if s is None:
                continue
            for d in {mesh.devices[iy][ix], first}:
                cur = torch.cuda.current_stream(d)
                cur.wait_stream(s)
                _tree_map(lambda t, c=cur: t.record_stream(c)
                          if t.device == c.device else None, outs[iy, ix])
        dy, dx = mesh.shape
        grid = lambda f: Sharded(tuple(tuple(f(outs[iy, ix])
                                             for ix in range(dx))
                                       for iy in range(dy)))
        state = grid(lambda o: o[0])
        bufs = outs[0, 0][1]
        planes = {}
        for name in bufs._fields:
            if name == "rays_traced":
                continue
            if getattr(bufs, name) is None:
                planes[name] = None
            elif isinstance(getattr(bufs, name), Vec3):
                planes[name] = Vec3(*[grid(lambda o, n=name, c=c: getattr(
                    getattr(o[1], n), c)) for c in ("x", "y", "z")])
            else:
                planes[name] = grid(lambda o, n=name: getattr(o[1], n))
        rays = None
        for iy, ix, *_ in tiles:
            r = _to(outs[iy, ix][1].rays_traced, first)
            rays = r if rays is None else rays + r
        return state, bufs._replace(rays_traced=rays, **planes)

    return fn
