"""Where K11's one-block kernel spends its time: the kernel with one part
cut out at a time, timed side by side on the card.

    python3 ptrt_tpu_torch/tools/k11_parts.py [--source FILE ...]
                                              [--sizes 1,10,192,1024]

Builds ``csrc/instances.cu`` (or each ``--source``, a copy of it with a
change to try) as it is and with each of these cut out, every variant its
own library built with the port's nvcc flags: ``notrig`` (the six sines
and cosines replaced by linear stand-ins), ``nocode`` (the centres'
re-read and the float64 Morton codes replaced by a hash of the id),
``nosort`` (the bitonic sort removed), ``notree`` (the tree levels above
the leaves removed) and ``empty`` (the kernel returns at once: the launch
floor).  Each is called through its C entry on seeded instances and timed
queued behind a spin of the card (two readings of 100 launches).  The cut
variants write wrong rows or trees: the numbers are times only.  Prints
one line a size with the card's name and power limit.
"""

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# (what is cut, the source text, what replaces it)
CUTS = {
    "notrig": [(f"const float c{a} = cosf(rr[{k}]), s{a} = sinf(rr[{k}]);",
                f"const float c{a} = 1.0f + 0.0f * rr[{k}], "
                f"s{a} = 0.5f * rr[{k}];") for k, a in enumerate("xyz")],
    "nocode": [("""        double c[3];
        centre(a.bmin, a.bmax, t, c);
        key = (static_cast<unsigned long long>(morton_code(c, lo, hi))
               << 32) | static_cast<unsigned>(t);""",
                """        key = (static_cast<unsigned long long>(
                   (t * 2654435761u) & 0x3fffffffu) << 32) |
              static_cast<unsigned>(t);""")],
    "nosort": [("    key = sort_keys(key, sort_buf);\n", "")],
    "notree": [("""    for (int level = 1; level < lv.n; ++level) {
        block_sync();
        for (int u = t; u < lv.count[level] * kWidth; u += threads)
            inner_row(tlas, lv, level, u);
    }
}""", "}")],
    "empty": [("""    __shared__ double red[6 * kMaxWarps];
""", """    __shared__ double red[6 * kMaxWarps];
    if (a.n > 0) return;
""")],
}


def variants(text: str) -> dict:
    """{name: source}: the source as it is, and each cut applied.  Raises
    ValueError naming a cut whose text the source no longer holds (the
    cuts follow the kernel's text: after an edit of the kernel, edit them
    too)."""
    out = {"base": text}
    for name, subs in CUTS.items():
        v = text
        for old, new in subs:
            if text.count(old) != 1:
                raise ValueError(f"k11_parts: the cut {name!r} does not "
                                 f"find its text once in the source")
            v = v.replace(old, new)
        out[name] = v
    return out


def build(sources: dict, nvcc: str, flags: list) -> dict:
    """{name: ctypes library}, every variant compiled at once."""
    tmp = tempfile.mkdtemp(prefix="k11_parts_")
    procs = {}
    for name, text in sources.items():
        cu = os.path.join(tmp, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [nvcc, *flags, "-fmad=false", "-shared", "-o",
             os.path.join(tmp, f"lib{name}.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs = {}
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{err[-3000:]}")
        lib = ctypes.CDLL(os.path.join(tmp, f"lib{name}.so"))
        lib.ptrt_instances_update.restype = i
        lib.ptrt_instances_update.argtypes = [p] * 5 + [i] + [p] * 4 + [
            i, p, p, p]
        libs[name] = lib
    return libs


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append",
                    help="an instances.cu to measure (default: this tree's)")
    ap.add_argument("--sizes", default="1,10,192,1024")
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    from ptrt_tpu_torch import kernels
    from ptrt_tpu_torch.geometry.tlas import level_layout, tlas_node_count
    from ptrt_tpu_torch.tools import stages

    if not torch.cuda.is_available():
        raise SystemExit("k11_parts: needs a GPU")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    sources = {}
    for path in args.source or [os.path.join(kernels.CSRC, "instances.cu")]:
        tag = "" if not args.source else os.path.basename(path) + ":"
        with open(path) as f:
            for name, text in variants(f.read()).items():
                sources[tag + name] = text
    libs = build(sources, kernels.nvcc_path(), kernels.NVCC_FLAGS)
    for n in (int(v) for v in args.sizes.split(",")):
        rng = np.random.default_rng(n)
        arrays = (rng.uniform(-50, 50, (n, 3)), rng.uniform(-9, 9, (n, 3)),
                  rng.uniform(0.2, 3, (n, 3)), -rng.uniform(0.1, 2, (n, 3)),
                  rng.uniform(0.1, 2, (n, 3)))
        ins = [torch.from_numpy(a.astype(np.float32)).to(dev)
               for a in arrays]
        f32 = dict(dtype=torch.float32, device=dev)
        outs = [torch.zeros((n, 24), **f32), torch.zeros((n, 3), **f32),
                torch.zeros((n, 3), **f32),
                torch.zeros((tlas_node_count(n), 4, 8), **f32)]
        counts, offs = level_layout(n)
        c_counts = (ctypes.c_int * len(counts))(*counts)
        c_offs = (ctypes.c_int * len(offs))(*offs)
        row = []
        for name, lib in libs.items():
            def call(_=None, lib=lib):
                rc = lib.ptrt_instances_update(
                    *[t.data_ptr() for t in ins], n,
                    *[t.data_ptr() for t in outs], len(counts), c_counts,
                    c_offs, kernels.stream_ptr(dev))
                kernels.check(rc, "instances_update")
            ms = [stages.clones_ms(call, [None] * 101, stages.SPIN_CYCLES)
                  for _ in range(2)]
            row.append(f"{name} {ms[0]:.4f} / {ms[1]:.4f}")
        print(f"[k11_parts] {n} instances, ms queued: " + ", ".join(row)
              + f" [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
