"""K11's wrapper after its Hopper redesign, on the CPU.

* The grid path's block size in the wrapper equals ``csrc/instances.cu``'s,
  and the one-block kernel takes a thread an instance up to a block's
  threads (``kOneBlockMax = kMaxThreads``).
* The one-block kernel's sorting network (thread t holds sorted position
  t; distance j exchanged by lane shuffles below 32, through shared memory
  past that), emulated here in numpy on the next power of two of at least
  32 keys, sorts distinct (code, id) keys into ``tlas.morton_order``'s
  stable order at sizes up to the one-block limit; its shared stages and
  block barriers are the counts the kernel's comment gives.
* The wrapper's checks of the grid path's scratch, and the CPU path at the
  limit and one past it: the tree ``build_tlas``'s of the boxes written,
  bit for bit.
* ``tools/k11_parts.py``'s cuts: each applied once, and a cut whose text
  is gone raises.
"""

import os
import re

import numpy as np
import pytest
import torch

from ptrt_tpu_torch.geometry import dtransform as dt
from ptrt_tpu_torch.geometry import tlas
from test_torch_shading import torch_one_thread  # noqa: F401

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "ptrt_tpu_torch", "csrc", "instances.cu")


def _constexpr(name: str) -> str:
    m = re.search(rf"constexpr int {name} = (\w+);", open(SOURCE).read())
    assert m, name
    return m.group(1)


def test_wrapper_constants_match_the_kernel_source():
    assert int(_constexpr("kGridThreads")) == dt._GRID_THREADS
    # the one-block kernel: a thread an instance, up to a block's threads
    assert _constexpr("kOneBlockMax") == "kMaxThreads"
    assert int(_constexpr("kMaxThreads")) == 1024


def _threads(n: int) -> int:
    """The one-block kernel's threads for ``n`` instances: the next power
    of two, at least a warp."""
    threads = 32
    while threads < n:
        threads <<= 1
    return threads


def _network(keys: np.ndarray):
    """The kernel's sort of ``keys`` (a key a thread), stage by stage.
    Returns (keys by sorted position, the stages that went through shared
    memory)."""
    p = np.arange(len(keys))  # thread t holds sorted position t
    key = keys.copy()
    shared = 0
    k = 2
    while k <= len(keys):
        j = k >> 1
        while j > 0:
            shared += j >= 32  # past a warp: shared memory and a barrier
            other = key[p ^ j]
            lower, up = (p & j) == 0, (p & k) == 0
            key = np.where(lower == up, np.minimum(key, other),
                           np.maximum(key, other))
            j >>= 1
        k <<= 1
    return key, shared


def _shared_stages(threads: int) -> int:
    """Bitonic stages of distance >= 32 over ``threads`` keys: for each
    merge width 2^e past a warp, the distances 2^(e-1) .. 32."""
    span = threads.bit_length() - 6
    return span * (span + 1) // 2 if span > 0 else 0


@pytest.mark.parametrize("n", [1, 10, 32, 33, 64, 192, 256, 511, 1000,
                               1024])
def test_sorting_network_gives_the_stable_morton_order(n):
    threads = _threads(n)
    assert threads in (32, 64, 128, 256, 512, 1024)
    rng = np.random.default_rng(n)
    codes = rng.integers(0, 64, n).astype(np.uint64)  # many ties
    keys = np.full(threads, np.iinfo(np.uint64).max, np.uint64)
    keys[:n] = (codes << np.uint64(32)) | np.arange(n, dtype=np.uint64)
    got, shared = _network(keys)
    assert shared == _shared_stages(threads)
    ids = (got[:n] & np.uint64(0xFFFFFFFF)).astype(np.int64)
    assert np.array_equal(ids, np.argsort(codes, kind="stable"))
    # a set's leaf rows (n rounded up to the tree's width) fit its threads
    assert tlas.level_layout(n)[0][0] * tlas.TLAS_WIDTH <= threads


def test_block_shape_at_the_games_sets():
    """The fluid's 1 and the cube slider's 10 instances run in one warp
    with no block barrier; tycoon's 192 in 8 warps with 10 barriers (the
    bounds, 6 sort stages, 3 tree levels) where the first design had 32
    warps and ~40."""
    for n in (1, 10, 32):
        assert _threads(n) == 32
        assert _network(np.arange(32, dtype=np.uint64))[1] == 0
    threads = _threads(192)
    shared = _network(np.arange(threads, dtype=np.uint64))[1]
    levels = len(tlas.tlas_levels(192)) - 1
    assert (threads, shared, 1 + shared + levels) == (256, 6, 10)
    # the one-block limit's sort buffers: two of 8 B a key, in the 48 KB a
    # launch gets by default
    assert 2 * 8 * _threads(1024) <= 48 * 1024


def _set(n):
    rng = np.random.default_rng(n)
    pos = torch.from_numpy(rng.uniform(-50, 50, (n, 3)).astype(np.float32))
    rot = torch.from_numpy(rng.uniform(-9, 9, (n, 3)).astype(np.float32))
    scale = torch.from_numpy(rng.uniform(0.2, 3, (n, 3)).astype(np.float32))
    lo = torch.from_numpy(-rng.uniform(0.1, 2, (n, 3)).astype(np.float32))
    hi = torch.from_numpy(rng.uniform(0.1, 2, (n, 3)).astype(np.float32))
    bufs = [torch.full((n, 24), np.nan), torch.full((n, 3), np.nan),
            torch.full((n, 3), np.nan),
            torch.full((tlas.tlas_node_count(n), tlas.TLAS_WIDTH,
                        tlas.TLAS_ROW), np.nan)]
    return [pos, rot, scale, lo, hi], bufs


@pytest.mark.parametrize("n", [1024, 1025])  # kOneBlockMax, one past it
def test_cpu_path_at_the_limit(n):
    ins, bufs = _set(n)
    scratch = dt.instances_scratch(n, "cpu")
    dt.instances_update(*ins, *bufs, scratch)
    want = tlas.build_tlas(bufs[1].numpy(), bufs[2].numpy())
    assert np.array_equal(bufs[3].numpy().view(np.uint32),
                          want.view(np.uint32))
    for got, ref in zip(bufs, dt.instances_update_plain(*ins)):
        assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


def test_wrapper_checks_path_cap_and_scratch():
    """The grid path's scratch is checked wherever it is given, and on the
    CPU (the plain version) it changes nothing."""
    ins, bufs = _set(40)
    dt.instances_update(*ins, *bufs)
    want = [b.clone() for b in bufs]
    good = dt.instances_scratch(40, "cpu")
    assert tuple(good.partial.shape) == (1, 6)
    dt.instances_update(*ins, *bufs, good)
    for got, ref in zip(bufs, want):
        assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    bad = [good._replace(partial=torch.zeros((2, 6), dtype=torch.float64)),
           good._replace(codes=torch.zeros(40, dtype=torch.int64)),
           good._replace(order=torch.zeros(39, dtype=torch.int64)),
           dt.instances_scratch(41, "cpu")]
    for s in bad:
        with pytest.raises((ValueError, TypeError), match="scratch"):
            dt.instances_update(*ins, *bufs, s)


def test_k11_parts_cuts_apply_to_the_kernel_source():
    """``tools/k11_parts.py`` times the kernel with each part cut out: each
    cut replaces its text once, and a cut whose text is not in the source
    raises rather than timing the whole kernel under its name."""
    from ptrt_tpu_torch.tools import k11_parts

    text = "\n".join(old for subs in k11_parts.CUTS.values()
                     for old, _ in subs)
    got = k11_parts.variants(text)
    assert set(got) == {"base", *k11_parts.CUTS}
    assert len(set(got.values())) == len(got)
    for name, subs in k11_parts.CUTS.items():
        want = text
        for old, new in subs:
            want = want.replace(old, new)
        assert got[name] == want != text
    name = next(iter(k11_parts.CUTS))
    with pytest.raises(ValueError, match=name):
        k11_parts.variants(text.replace(k11_parts.CUTS[name][0][0], ""))
