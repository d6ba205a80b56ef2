"""Run one cell of ``BENCHMARK.json`` once on the card and print its result
as the last line of standard output (one JSON object).

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a profiled stretch of the window.  The run exits
non-zero and prints no result where there is no CUDA card, or fewer than
the cell asks for, or where ``sys.modules`` holds ``jax``, ``jaxlib``,
``flax`` or ``ptrt_tpu`` once the window has closed.  The numbers that
decide ``correct`` are printed with their limits as the last lines of
standard error and under the result's last key, ``checked``.
``--control 1`` puts the reference computed in bfloat16 in the program's
place for those numbers (the control; never a benchmark run)."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark import cells, session

    cell = cells.load(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("benchmark: no CUDA card here; the benchmark runs only on one",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {args.workload} needs {cell.chips} cards, this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = session.run(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), T_START,
                      control=bool(args.control))
    bad = session.forbidden_modules()
    if bad:
        print("benchmark: the run loaded modules it may not: "
              + ", ".join(bad), file=sys.stderr)
        return 3
    from ptrt_tpu_torch.app.demo import card_line

    print(f"card: {card_line(torch.device('cuda', 0))}", file=sys.stderr)
    for name, c in out["checked"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
