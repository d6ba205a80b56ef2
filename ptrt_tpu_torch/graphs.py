"""CUDA graphs of whole frames: capture once, replay every frame.

The port's counterpart of ``jax.jit`` over a frame (the reference's fused
game frame, ``ptrt_tpu/games/fused.py``, and ``__graft_entry__.entry``):
the frame's hand-written kernels and torch ops are recorded once into a
``torch.cuda.CUDAGraph``, and each frame is then one ``replay()`` with no
Python on the way.  A graph reads and writes fixed addresses, so what
changes from frame to frame lives on the card in static buffers:

* tensors (the game state, the PCG state, the denoiser history, the
  camera) are copied into the graph's static inputs (``copy_tree``);
* host values (a frame index, a game's inputs) are staged by
  ``HostValues``: one non-blocking copy from pinned memory into one device
  buffer, on the stream the graph replays on, so nothing synchronizes.

``capture_frame`` warms a body up on a side stream and captures it;
``capture`` wraps a function of tensors as a callable that fills its
static inputs and replays (what ``jax.jit`` of it is in the reference).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable

import numpy as np
import torch

from ptrt_tpu_torch import kernels
from ptrt_tpu_torch.core.vec import Vec3

# -- trees of tensors ----------------------------------------------------------


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


def copy_tree(dst, src) -> None:
    """Copy each tensor leaf of ``src`` into the same leaf of ``dst`` (the
    same structure and shapes), in stream order."""
    d, s = tree_leaves(dst), tree_leaves(src)
    if len(d) != len(s):
        raise ValueError(f"trees of {len(d)} and {len(s)} tensors")
    for a, b in zip(d, s):
        if a is not b:
            a.copy_(b)


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


def capture_frame(body: Callable, warmup: Callable, device):
    """Run ``warmup()`` once on a side stream (torch's recipe before a
    capture), then capture ``body()`` into a new ``torch.cuda.CUDAGraph``
    with its own memory pool.  Returns (graph, what ``body`` returned, the
    kernel launches one replay makes: the wrappers' counts during the
    capture, which records kernels and launches none).  Raises if the
    capture fails: there is no eager fall-back."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"a CUDA graph needs a CUDA device, not {device}")
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        warmup()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with kernels.recorded() as recorded:
        with torch.cuda.graph(graph):
            out = body()
    return graph, out, collections.Counter(recorded)


class Graph:
    """A captured function of tensors: ``graph(*args)`` copies ``args``
    into the static inputs (tensor leaves; other leaves must equal the
    capture's), replays, and returns the static outputs (overwritten by
    the next call; clone what must outlive it)."""

    def __init__(self, fn: Callable, args: tuple, device):
        self.device = torch.device(device)
        self.inputs = clone_tree(tuple(args))
        self._static = repr(map_tree(lambda t: None, self.inputs))
        self.graph, self.outputs, self.launches = capture_frame(
            lambda: fn(*self.inputs), lambda: fn(*self.inputs), self.device)

    def replay(self) -> None:
        self.graph.replay()
        kernels.replays.update(self.launches)

    def __call__(self, *args):
        if repr(map_tree(lambda t: None, tuple(args))) != self._static:
            raise ValueError("the arguments' structure or host values differ "
                             "from the capture's")
        copy_tree(self.inputs, tuple(args))
        self.replay()
        return self.outputs


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
