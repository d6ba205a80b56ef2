"""Row-gather probes: the port's counterpart of the Pallas row-gather probes
``tools/probe_pallas_gather_r5.py``, ``tools/probe_pallas_gather2_r5.py``
and ``tools/prof_pallas_gather.py``.

Every one of those probes computes ``out[r, :] = table[idx[r], :]``.  Here
each probe builds its table and indices at the Pallas probe's shape, runs
``row_gather`` (the ``csrc/gather.cu`` kernel on a GPU) and its plain
version ``index_select`` on the same inputs, checks that the two agree bit
for bit, and times both with CUDA events.

Run on a GPU:  python -m ptrt_tpu_torch.tools.probe_gather
"""

from __future__ import annotations

import json
import sys
from typing import Callable, NamedTuple

import numpy as np
import torch

from ptrt_tpu_torch.core.gather import row_gather, row_gather_plain
from ptrt_tpu_torch.tools import cuda_ms

# prof_pallas_gather.py: 8 dependent gathers, each index fed back as
# (i + int(row sum)) % N
CHAIN = 8
# H100 SXM device memory rate, for a probe's bound (a gather does no
# arithmetic, so its bytes bound it)
HBM_BYTES_PER_S = 3.35e12


class Probe(NamedTuple):
    name: str
    source: str  # the Pallas probe it mirrors, file:line
    make: Callable  # device -> (table, idx)
    run: Callable  # (gather, table, idx) -> output


def _single(gather, table, idx):
    return gather(table, idx)


def lane_form(gather, table, idx):
    """``probe_taa_axis1``: ``out[i, j] = table[i, idx[j] % W]``, the lane
    gather, as a row gather of the transposed table."""
    w = table.shape[1]
    return gather(table.t().contiguous(), idx[:w] % w).t()


def chained(gather, table, idx):
    """``prof_pallas_gather.py``: ``CHAIN`` dependent gathers; each row sum
    moves the index on and is accumulated.  Returns the (R,) sums."""
    n = table.shape[0]
    acc = torch.zeros(idx.shape, dtype=torch.float32, device=idx.device)
    for _ in range(CHAIN):
        s = gather(table, idx).sum(dim=1)
        idx = (idx + s.to(torch.int32)) % n
        acc = acc + s
    return acc


def _arange_table(k, w, scale, dev):
    t = torch.arange(k * w, dtype=torch.float32, device=dev).reshape(k, w)
    return t * scale if scale != 1.0 else t


def _random(k, w, r, dtype, seed, dev, integer=False):
    g = np.random.default_rng(seed)
    t = (g.integers(-4, 5, (k, w)) if integer
         else g.normal(size=(k, w))).astype(np.float32)
    i = g.integers(0, k, r).astype(np.int32)
    return (torch.from_numpy(t).to(dev, dtype),
            torch.from_numpy(i).to(dev))


PROBES = [
    Probe("r5 vector index (2048x128 f32, 1024 idx)",
          "tools/probe_pallas_gather_r5.py:42",
          lambda dev: (_arange_table(2048, 128, 1.0, dev),
                       torch.arange(1024, dtype=torch.int32,
                                    device=dev).flip(0) % 2048),
          _single),
    Probe("r5-2 same-n take (2048x128 f32, 2048 idx)",
          "tools/probe_pallas_gather2_r5.py:38",
          lambda dev: (_arange_table(2048, 128, 1e-4, dev),
                       (torch.arange(2048, dtype=torch.int32,
                                     device=dev).flip(0) * 7) % 2048),
          _single),
    Probe("r5-2 lane form (2048x128 f32, 128 idx, transposed)",
          "tools/probe_pallas_gather2_r5.py:38",
          lambda dev: (_arange_table(2048, 128, 1e-4, dev),
                       (torch.arange(2048, dtype=torch.int32,
                                     device=dev).flip(0) * 7) % 2048),
          lane_form),
    Probe("r5-2 taa_kernel (2048x64 f32, 1M idx)",
          "tools/probe_pallas_gather2_r5.py:158",
          lambda dev: _random(2048, 64, 1 << 20, torch.float32, 1, dev),
          _single),
    Probe("r5-2 oh_kernel (2048x64 bf16, 1M idx)",
          "tools/probe_pallas_gather2_r5.py:133",
          lambda dev: _random(2048, 64, 1 << 20, torch.bfloat16, 1, dev),
          _single),
    Probe("prof gather (1024x64 f32, 230400 idx)",
          "tools/prof_pallas_gather.py:79",
          lambda dev: _random(1024, 64, 230_400, torch.float32, 0, dev),
          _single),
    Probe(f"prof chained x{CHAIN} (1024x64 f32, 230400 idx)",
          "tools/prof_pallas_gather.py:79,107,138,166",
          lambda dev: _random(1024, 64, 230_400, torch.float32, 0, dev,
                              integer=True),
          chained),
]


def moved_bytes(p: Probe, table, idx, out) -> int:
    """Bytes a probe must move: the table and the indices read once, the
    gathered rows written once (for the chain, each of its gathers)."""
    nb = lambda t: t.element_size() * t.numel()
    if p.run is chained:
        row = table.shape[1] * table.element_size()
        return nb(table) + CHAIN * (nb(idx) + idx.numel() * row)
    if p.run is lane_form:
        return nb(table) + table.shape[1] * idx.element_size() + nb(out)
    return nb(table) + nb(idx) + nb(out)


def run_probes(dev, iters: int = 20) -> list[dict]:
    """Every probe on ``dev`` (a CUDA device): the kernel against its plain
    version, bit for bit, both times and the probe's bound.  Where the plain
    version is one ``index_select`` call, its time is also the library
    call's (``library_ms``).  Raises if any disagrees."""
    rows = []
    for p in PROBES:
        table, idx = p.make(dev)
        got = p.run(row_gather, table, idx)
        want = p.run(row_gather_plain, table, idx)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"row_gather differs from index_select on "
                                 f"{p.name}")
        plain_ms = cuda_ms(lambda: p.run(row_gather_plain, table, idx),
                           iters)
        rows.append({
            "probe": p.name, "replaces": p.source,
            "table": list(table.shape), "dtype": str(table.dtype),
            "idx": int(idx.numel()), "exact": True,
            "ms": cuda_ms(lambda: p.run(row_gather, table, idx), iters),
            "plain_ms": plain_ms,
            "library_ms": plain_ms if p.run is _single else None,
            "bound_ms": 1e3 * moved_bytes(p, table, idx, want)
            / HBM_BYTES_PER_S, "bound_by": "bytes"})
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("probe_gather: needs a GPU")
    dev = torch.device("cuda", 0)
    print(torch.cuda.get_device_name(0), flush=True)
    for row in run_probes(dev):
        print(f"{row['probe']:52s} kernel {row['ms']:.4f} ms  "
              f"index_select {row['plain_ms']:.4f} ms  bound "
              f"{row['bound_ms']:.4f} ms  exact", flush=True)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
