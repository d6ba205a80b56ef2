"""CUDA graphs of whole frames: capture once, replay every frame.

The port's counterpart of ``jax.jit`` over a frame (the reference's fused
game frame, ``ptrt_tpu/games/fused.py``, and ``__graft_entry__.entry``):
the frame's hand-written kernels and torch ops are recorded once into a
``torch.cuda.CUDAGraph``, and each frame is then one ``replay()`` with no
Python on the way.  A graph reads and writes fixed addresses, so what
changes from frame to frame lives on the card in static buffers:

* tensors (the game state, the PCG state, the denoiser history, the
  camera) are copied into the program's buffers (``Program``);
* host values (a frame index, a game's inputs) are staged by
  ``HostValues``: one non-blocking copy from pinned memory into one device
  buffer, on the stream the graph replays on, so nothing synchronizes.

``capture_frame`` warms a body up on a side stream and captures it;
``Program`` is a frame body kept per configuration (``signature`` is the
part of its key that ``jax.jit`` retraces on) on buffers of its own, into
which it copies what the caller changed, and on the CPU calls the body
where the card replays the graph; ``Programs`` keeps them, for one world
at a time.  ``capture`` wraps a function of tensors as a program that
copies in its arguments and replays (what ``jax.jit`` of it is in the
reference).  The fused game frame (``games/fused.py``) is a ``Program``
too: one copy-in rule serves every captured frame.
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import itertools
import time
import weakref
from typing import Callable

import numpy as np
import torch

from ptrt_tpu_torch import kernels
from ptrt_tpu_torch.core.vec import Vec3

# -- trees of tensors ----------------------------------------------------------


class Shared:
    """A tensor that nothing writes after it is made (an HDRI's quads,
    ``render/sky.py``), held in a tree as a leaf of its own: ``map_tree``
    and ``tree_leaves`` pass it by, so a ``Program`` reads it where it lies
    and keeps no copy, and ``signature`` tells each one made apart.  So a
    new one is a new world: ``Programs`` makes its programs anew, and a
    ``Program`` refuses a run with another one than it was made with."""

    _made = itertools.count()

    def __init__(self, tensor: torch.Tensor):
        self.tensor = tensor
        self._serial = next(Shared._made)

    def __repr__(self) -> str:
        return f"Shared#{self._serial}{tuple(self.tensor.shape)}"


def shared_leaves(tree) -> list:
    """The ``Shared`` leaves of ``tree``, in ``map_tree``'s order."""
    if isinstance(tree, Shared):
        return [tree]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        parts = [getattr(tree, f.name) for f in dataclasses.fields(tree)
                 if f.init]
    elif isinstance(tree, (tuple, list)):
        parts = tree
    elif isinstance(tree, dict):
        parts = tree.values()
    else:
        return []
    return [s for part in parts for s in shared_leaves(part)]


def map_tree(fn: Callable, tree):
    """``tree`` with ``fn`` applied to each tensor leaf: through tuples,
    lists, NamedTuples, dicts, ``Vec3`` and dataclasses; other leaves
    (None, numbers) are kept as they are."""
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, Vec3):
        return tree.map(fn)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: map_tree(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[map_tree(fn, v) for v in tree])
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_tree(fn, v) for v in tree)
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    return tree


def tree_leaves(tree) -> list:
    """The tensor leaves of ``tree`` in ``map_tree``'s order."""
    out = []
    map_tree(out.append, tree)
    return out


def clone_tree(tree):
    return map_tree(torch.clone, tree)


# -- host values -------------------------------------------------------------


def _kind(v) -> str:
    """'i' (stored as int32) or 'f' (float32) for one host leaf."""
    if isinstance(v, (bool, int, np.integer)):
        return "i"
    if isinstance(v, (float, np.floating)):
        return "f"
    if (torch.is_tensor(v) and v.dim() == 0 and v.device.type == "cpu"):
        if v.dtype == torch.float32:
            return "f"
        if not v.dtype.is_floating_point and v.dtype != torch.bool:
            return "i"
    raise TypeError("a host value must be a Python or numpy number or a 0-d "
                    f"float32 or integer CPU tensor, got {v!r}")


def _host_leaves(tree, out: list):
    """The structure of ``tree`` with its host leaves taken out into
    ``out`` (tuples and lists are walked, everything else is a leaf)."""
    if isinstance(tree, (tuple, list)) and not hasattr(tree, "_fields"):
        return type(tree), [_host_leaves(v, out) for v in tree]
    out.append(tree)
    return None


def _rebuild(spec, leaves):
    if spec is None:
        return next(leaves)
    kind, parts = spec
    return kind(_rebuild(p, leaves) for p in parts)


class HostValues:
    """Host values of a fixed structure (nested tuples and lists of Python
    numbers and 0-d CPU tensors) staged on ``device``: ints as int32,
    floats as float32, all in one device buffer allocated once.  On the
    card each ``stage`` fills a pinned host block (from torch's caching
    host allocator, which hands a block out again only once its copy has
    run) and copies it with one non-blocking copy on the current stream:
    the host never waits, and a frame captured after it reads the values
    in stream order.  ``fixed``: the structure may not change after the
    first call (a captured graph holds the buffer's views)."""

    def __init__(self, device, fixed: bool = False):
        self.device = torch.device(device)
        self.fixed = fixed
        self._key = None
        self._buf = None
        self._views = None

    def stage(self, tree):
        """The values of ``tree`` as 0-d device tensors, in its structure
        (views of the buffer: the next ``stage`` overwrites them in stream
        order)."""
        leaves = []
        spec = _host_leaves(tree, leaves)
        kinds = "".join(_kind(v) for v in leaves)
        key = (repr(spec), kinds)
        if key != self._key:
            if self.fixed and self._key is not None:
                raise ValueError("the staged values' structure changed "
                                 f"from {self._key} to {key}")
            self._key = key
            self._buf = torch.empty(len(kinds), dtype=torch.int32,
                                    device=self.device)
            self._views = [
                self._buf[k] if c == "i"
                else self._buf[k:k + 1].view(torch.float32)[0]
                for k, c in enumerate(kinds)]
        words = np.empty(len(kinds), np.int32)
        for k, (c, v) in enumerate(zip(kinds, leaves)):
            if torch.is_tensor(v):
                v = v.item()
            words[k] = (np.int32(v) if c == "i"
                        else np.float32(v).view(np.int32))
        if self.device.type == "cuda":
            host = torch.empty(len(kinds), dtype=torch.int32,
                               pin_memory=True)
            host.numpy()[:] = words
            self._buf.copy_(host, non_blocking=True)
        else:
            self._buf.copy_(torch.from_numpy(words))
        return _rebuild(spec, iter(self._views))


# -- capture -------------------------------------------------------------------


def capture_frame(body: Callable, warmup: Callable, device,
                  stats: dict | None = None):
    """Run ``warmup()`` once on a side stream (torch's recipe before a
    capture; its wrapper calls count nowhere), then capture ``body()`` into
    a new ``torch.cuda.CUDAGraph`` with its own memory pool.  Returns
    (graph, what ``body`` returned, the kernel launches one replay makes:
    the wrappers' counts during the capture, which records kernels and
    launches none).  ``stats``: receives "capture_s" (the capture alone)
    and "pool_bytes" (the memory the card reserved for it).  Raises if the
    capture fails: there is no eager fall-back."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"a CUDA graph needs a CUDA device, not {device}")
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with kernels.recorded(), torch.cuda.stream(side):
        warmup()
    torch.cuda.current_stream(device).wait_stream(side)
    # torch.cuda.graph empties the allocator's cache before it captures:
    # empty it first, so the reserved bytes that grow are the graph pool's
    torch.cuda.synchronize(device)
    gc.collect()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(device)
    t0 = time.perf_counter()
    graph = torch.cuda.CUDAGraph()
    with kernels.recorded() as recorded:
        with torch.cuda.graph(graph):
            out = body()
    if stats is not None:
        stats["capture_s"] = time.perf_counter() - t0
        stats["pool_bytes"] = torch.cuda.memory_reserved(device) - reserved
    return graph, out, collections.Counter(recorded)


class Graph:
    """A captured function of tensors: a ``Program`` whose reads are the
    arguments, all copied in at every call.  ``graph(*args)`` copies the
    tensor leaves of ``args`` into the program's buffers (other leaves
    must equal the capture's), replays, and returns the static outputs
    (overwritten by the next call; clone what must outlive it)."""

    def __init__(self, fn: Callable, args: tuple, device):
        self._static = repr(map_tree(lambda t: None, tuple(args)))
        self.program = Program(
            lambda reads, st, values: (fn(*reads["args"]), None),
            {"args": tuple(args)}, None, None, device, edited=("args",))

    @property
    def launches(self) -> collections.Counter:
        """The kernel launches one replay makes."""
        return self.program.launches

    def __call__(self, *args):
        if repr(map_tree(lambda t: None, tuple(args))) != self._static:
            raise ValueError("the arguments' structure or host values differ "
                             "from the capture's")
        return self.program.run({"args": tuple(args)}, None, None)


def capture(fn: Callable, args: tuple):
    """``fn`` captured on the device of ``args``' tensors as a ``Graph``
    (the counterpart of ``jax.jit(fn)``); on the CPU there is nothing to
    capture and ``fn`` is returned."""
    leaves = tree_leaves(tuple(args))
    if not leaves:
        raise ValueError("capture needs at least one tensor argument")
    device = leaves[0].device
    if device.type != "cuda":
        return fn
    return Graph(fn, tuple(args), device)


# -- programs kept per configuration ------------------------------------------


def signature(tree) -> tuple:
    """What a captured program is specialised to, as ``jax.jit`` retraces
    on it: the structure of ``tree``, each tensor leaf's shape and dtype,
    and every other leaf's value (a tree's depth bound, an HDRI's sampling
    size, None where a table is absent), in ``map_tree``'s order."""
    out = []

    def walk(t):
        if torch.is_tensor(t):
            out.append((tuple(t.shape), t.dtype))
        elif isinstance(t, Vec3):
            out.append("Vec3")
            for c in (t.x, t.y, t.z):
                walk(c)
        elif dataclasses.is_dataclass(t) and not isinstance(t, type):
            out.append(type(t).__name__)
            for f in dataclasses.fields(t):
                walk(getattr(t, f.name))
        elif isinstance(t, (tuple, list)):
            out.append((type(t).__name__, len(t)))
            for v in t:
                walk(v)
        elif isinstance(t, dict):
            for k, v in t.items():
                out.append(k)
                walk(v)
        elif t is None or isinstance(t, (bool, int, float, str)):
            out.append(t)
        else:
            out.append(repr(t))

    walk(tree)
    return tuple(out)


def _pairs(dst, src, out: list) -> None:
    """(buffer, source) for each tensor leaf of ``dst`` and the same leaf of
    ``src`` (one structure); a None in ``src`` pairs nothing beneath it."""
    if src is None:
        return
    if type(src) is not type(dst) and not (torch.is_tensor(src)
                                           and torch.is_tensor(dst)):
        raise ValueError(f"a {type(src).__name__} for a "
                         f"{type(dst).__name__}")
    if torch.is_tensor(dst):
        out.append((dst, src))
    elif isinstance(dst, Vec3):
        for c in "xyz":
            _pairs(getattr(dst, c), getattr(src, c), out)
    elif dataclasses.is_dataclass(dst) and not isinstance(dst, type):
        for f in dataclasses.fields(dst):
            _pairs(getattr(dst, f.name), getattr(src, f.name), out)
    elif isinstance(dst, (tuple, list)):
        if len(dst) != len(src):
            raise ValueError(f"trees of {len(dst)} and {len(src)} entries")
        for a, b in zip(dst, src):
            _pairs(a, b, out)
    elif isinstance(dst, dict):
        for k, v in dst.items():
            _pairs(v, src[k], out)


def _copy_in(buf: torch.Tensor, src: torch.Tensor) -> None:
    if src.shape != buf.shape or src.dtype != buf.dtype:
        raise ValueError(f"a {tuple(src.shape)} {src.dtype} tensor for a "
                         f"{tuple(buf.shape)} {buf.dtype} buffer")
    buf.copy_(src)


def copy_tree(dst, src) -> None:
    """Copy each tensor leaf of ``src`` that is not the same leaf of ``dst``
    into it, in stream order: one structure, shapes and dtypes (else
    ValueError); a None in ``src`` keeps ``dst``'s leaves beneath it."""
    pairs = []
    _pairs(dst, src, pairs)
    for buf, s in pairs:
        if s is not buf:
            _copy_in(buf, s)


class Program:
    """A frame body kept per configuration and run once a frame: the port's
    counterpart of a jitted program of the reference, which its cache keeps
    per static key.

    ``body(reads, state, values) -> (outputs, new_state)`` is the frame on
    three trees: ``reads``, the tensors it only reads (geometry, tables,
    camera); ``state``, the tensors it carries from frame to frame; and
    ``values``, host numbers staged on the device (``HostValues``; None
    for none).  It writes nothing else.  The program's buffers are its
    own: copies of ``reads`` and ``state`` made at creation, but for the
    ``Shared`` leaves of ``reads``, which it reads where they lie.  A
    caller's tensor is never written, and one it held earlier and puts
    back is a change like any other.

    ``run(reads, state, values)`` copies into the buffers what changed
    since: a read leaf that is another tensor than the one last copied
    into its buffer (a new camera, a table made again, an earlier one put
    back); every leaf of a group named in ``edited``, whose tensors the
    caller writes in place (the instance tables K5's refits write), at
    every run; and a state leaf that is not its buffer (a None in
    ``state`` keeps the buffers beneath it).  Shapes and dtypes must be
    the buffers'.  It stages ``values`` and runs the body: on the card one
    ``replay()`` of the graph captured at creation (after a warm-up on a
    side stream), whose outputs are static (the next run overwrites
    them); on the CPU it calls the body on the buffers.  Either way it
    writes the new state into the state buffers, and returns the
    outputs."""

    def __init__(self, body: Callable, reads: dict, state, values, device,
                 edited: tuple = ()):
        self.device = torch.device(device)
        self.body = body
        self.reads = clone_tree(reads)
        self.state = clone_tree(state)
        self._shared = shared_leaves(reads)
        self._edited = []
        for name, group in reads.items():
            self._edited += [name in edited] * len(tree_leaves(group))
        # the tensor last copied into each read buffer (weakly: a program
        # keeps none of its caller's tensors alive)
        self._last = [weakref.ref(t) for t in tree_leaves(reads)]
        self._values = HostValues(self.device, fixed=True)
        self._staged = None if values is None else self._values.stage(values)
        self.graph = None
        self.outputs = None
        self.launches = collections.Counter()
        self.stats = {"capture_s": 0.0, "pool_bytes": 0}
        self.runs = 0  # frames run
        if self.device.type == "cuda":
            self.graph, self.outputs, self.launches = capture_frame(
                lambda: self._call(True), lambda: self._call(False),
                self.device, self.stats)

    def _call(self, write_back: bool):
        out, new_state = self.body(self.reads, self.state, self._staged)
        if write_back:
            copy_tree(self.state, new_state)
        return out

    def _refresh(self, reads: dict, state) -> None:
        """Copy into the buffers what ``run`` copies (see the class)."""
        shared = shared_leaves(reads)
        if len(shared) != len(self._shared) or any(
                a is not b for a, b in zip(shared, self._shared)):
            raise ValueError("a Shared read is not the one this program was "
                             "made with: make a new program")
        bufs = tree_leaves(self.reads)
        src = tree_leaves(reads)
        if len(src) != len(bufs):
            raise ValueError(f"{len(src)} read tensors for a program of "
                             f"{len(bufs)}")
        for k, (buf, s) in enumerate(zip(bufs, src)):
            if not self._edited[k] and self._last[k]() is s:
                continue
            _copy_in(buf, s)
            self._last[k] = weakref.ref(s)
        copy_tree(self.state, state)

    def run(self, reads: dict, state, values):
        self.runs += 1
        self._refresh(reads, state)
        if values is not None:
            self._values.stage(values)
        if self.graph is None:
            return self._call(True)
        self.graph.replay()
        kernels.replays.update(self.launches)
        return self.outputs


# the programs a cache keeps: a viewer's presets (fast, performance,
# balanced, quality, and ultra's chunk and post programs) and the
# wireframe's fit
PROGRAMS_KEPT = 8


class Programs(collections.OrderedDict):
    """Programs kept by key (the reference's cache of jitted programs), for
    one world at a time.  A program holds copies of the world it reads,
    and on the card its graph a memory pool of its own, so the cache
    bounds them: ``program(key, world, make)`` drops every program when
    ``world`` (the ``signature`` of what the frames read) is not the last
    one's, as after a mesh or light added or removed, and past
    ``PROGRAMS_KEPT`` programs the one run least recently.  ``made``: the
    programs made."""

    def __init__(self):
        super().__init__()
        self.world = None
        self.made = 0

    def program(self, key, world, make: Callable) -> Program:
        """The program of ``key``, made by ``make()`` at its first run."""
        if world != self.world:
            self.clear()
            self.world = world
        prog = self.get(key)
        if prog is not None:
            self.move_to_end(key)
            return prog
        while len(self) >= PROGRAMS_KEPT:
            self.popitem(last=False)
        prog = self[key] = make()
        self.made += 1
        return prog
