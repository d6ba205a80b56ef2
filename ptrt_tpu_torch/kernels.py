"""Build, load and count the port's hand-written CUDA kernels.

All kernels (``csrc/*.cu``) compile at first use with ``nvcc`` — one
process per source, all started together — and link into one shared
library with a plain C interface in the port's build directory
(``build.BUILD_DIR``), loaded with ``ctypes``.  Each C entry point launches
on the stream it is given, allocates nothing, and returns
``cudaGetLastError()``; ``check`` raises if that is not 0.

``launches`` counts kernel launches by name.  A wrapper adds one exactly
where it launches its kernel, so a run can show which kernels its path went
through.  A frame captured into a CUDA graph (``graphs.py``) launches its
kernels at each replay, with no wrapper call: its capture counts apart
(``recorded``), and each replay adds the capture's counts to ``replays``.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import os
import shutil

import torch

from ptrt_tpu_torch.build import BuildError, build_linked_library

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
# source -> its own nvcc flags: the post-stack and shading kernels follow
# their plain versions' float order, so no multiply may fuse into an add
SOURCE_FLAGS = {
    "traverse.cu": [], "tonemap.cu": ["-fmad=false"], "gather.cu": [],
    "svgf.cu": ["-fmad=false"], "bloom.cu": ["-fmad=false"],
    "shade.cu": ["-fmad=false"], "refit.cu": ["-fmad=false"],
    "rt_shade.cu": ["-fmad=false"], "instances.cu": ["-fmad=false"],
    "motion.cu": ["-fmad=false"], "camera.cu": ["-fmad=false"],
    "upscale.cu": ["-fmad=false"], "frame.cu": ["-fmad=false"],
}
SOURCES = [os.path.join(CSRC, f) for f in SOURCE_FLAGS]
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]
LIBRARY = "libptrt_kernels.so"


class Args(ctypes.Structure):
    """Base of the kernels' argument structures (``struct ...Args`` of
    ``csrc/*.cu`` and their parts): assigning a name that ``_fields_`` does
    not hold raises, where a plain ``ctypes.Structure`` keeps it as a Python
    attribute that the kernel never sees (a misspelt field would leave the
    kernel's zero)."""

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        cls._names = frozenset(f[0] for f in cls.__dict__.get("_fields_", ()))

    def __setattr__(self, name, value):
        if name not in self._names:
            raise AttributeError(f"{type(self).__name__} has no field "
                                 f"{name!r}")
        super().__setattr__(name, value)


launches: collections.Counter = collections.Counter()
# the kernels launched by CUDA graph replays, by name
replays: collections.Counter = collections.Counter()


def counts() -> collections.Counter:
    """The kernels launched since ``clear_counts``, by name: the wrappers'
    launches and the graph replays' together (a frame counts alike run
    eagerly or replayed)."""
    return launches + replays


def clear_counts() -> None:
    launches.clear()
    replays.clear()


@contextlib.contextmanager
def recorded():
    """Count the wrappers' calls inside the block in a Counter of their own
    (yielded), not in ``launches``: a capture into a CUDA graph records its
    kernels and launches none."""
    global launches
    outer, launches = launches, collections.Counter()
    try:
        yield launches
    finally:
        launches = outer

_lib = None


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise BuildError("nvcc not found (set CUDA_HOME)")
    return found


def get_lib() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library."""
    global _lib
    if _lib is None:
        nvcc = nvcc_path()
        path = build_linked_library(
            LIBRARY,
            {src: [nvcc, *NVCC_FLAGS, *SOURCE_FLAGS[os.path.basename(src)],
                   "-c", src] for src in SOURCES},
            [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a"])
        lib = bind_walks(ctypes.CDLL(path))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ptrt_closest_hit_counted.restype = i
        lib.ptrt_closest_hit_counted.argtypes = ([p, i, p, i] + [p] * 7
                                                 + [i, p, i] + [p] * 7)
        lib.ptrt_any_hit_counted.restype = i
        lib.ptrt_any_hit_counted.argtypes = ([p, i, p, i] + [p] * 7
                                             + [i, p, i, p, p, p])
        lib.ptrt_tonemap_rgb8.restype = i
        lib.ptrt_tonemap_rgb8.argtypes = [p, p]
        lib.ptrt_tonemap_info.restype = i
        lib.ptrt_tonemap_info.argtypes = [i, p, p]
        lib.ptrt_row_gather.restype = i
        lib.ptrt_row_gather.argtypes = [p, i, i, i, p, ctypes.c_longlong, p,
                                        i, p]
        lib.ptrt_svgf_temporal.restype = i
        lib.ptrt_svgf_temporal.argtypes = [p, p]
        lib.ptrt_svgf_temporal_info.restype = i
        lib.ptrt_svgf_temporal_info.argtypes = [i, p, p, p, p, p]
        lib.ptrt_svgf_atrous.restype = i
        lib.ptrt_svgf_atrous.argtypes = [p, p]
        lib.ptrt_svgf_atrous_info.restype = i
        lib.ptrt_svgf_atrous_info.argtypes = [i, i, i, i, p, p, p]
        for name in ("svgf_variance", "svgf_firefly", "motion_vectors",
                     "camera_rays", "camera_make", "upscale_bilinear",
                     "sample_sums", "progressive_average"):
            fn = getattr(lib, f"ptrt_{name}")
            fn.restype = i
            fn.argtypes = [p, p]
        lib.ptrt_bloom_chain.restype = i
        lib.ptrt_bloom_chain.argtypes = [p, p]
        lib.ptrt_bloom_chain_info.restype = i
        lib.ptrt_bloom_chain_info.argtypes = [p] * 6
        lib.ptrt_shade_nee.restype = i
        lib.ptrt_shade_nee.argtypes = [p, p]
        lib.ptrt_shade_scatter.restype = i
        lib.ptrt_shade_scatter.argtypes = [p, p]
        lib.ptrt_shade_info.restype = i
        lib.ptrt_shade_info.argtypes = [i, p, p, p, p, p, p, p]
        lib.ptrt_refit.restype = i
        lib.ptrt_refit.argtypes = ([p, p, p, i, p, p, p, i, p] + [p] * 9
                                   + [p, i, i, i] + [p] * 4
                                   + [i, p, p, p, i, p, i] + [p] * 5)
        lib.ptrt_refit_info.restype = i
        lib.ptrt_refit_info.argtypes = [p] * 5
        lib.ptrt_empty_launch.restype = i
        lib.ptrt_empty_launch.argtypes = [p]
        lib.ptrt_morton_sort.restype = i
        lib.ptrt_morton_sort.argtypes = [p, p, p, i, p, p, p]
        lib.ptrt_morton_sort_max.restype = i
        lib.ptrt_morton_sort_max.argtypes = []
        lib.ptrt_morton_codes.restype = i
        lib.ptrt_morton_codes.argtypes = [p, p, p, i, p, p, i, p]
        for name in ("light_rays", "shade", "glass_rays", "resolve"):
            fn = getattr(lib, f"ptrt_rt_{name}")
            fn.restype = i
            fn.argtypes = [p, p]
        lib.ptrt_rt_info.restype = i
        lib.ptrt_rt_info.argtypes = [i] + [p] * 6
        lib.ptrt_rt_resolve_glass_grid.restype = i
        lib.ptrt_rt_resolve_glass_grid.argtypes = [ctypes.c_longlong, p]
        lib.ptrt_instances_update_max.restype = i
        lib.ptrt_instances_update_max.argtypes = []
        lib.ptrt_instances_update.restype = i
        lib.ptrt_instances_update.argtypes = [p] * 5 + [i] + [p] * 4 + [
            i, p, p, p]
        lib.ptrt_instances_codes.restype = i
        lib.ptrt_instances_codes.argtypes = [p] * 5 + [i] + [p] * 6
        lib.ptrt_instances_levels.restype = i
        lib.ptrt_instances_levels.argtypes = [p, p, i, p, p, i, p, p, p]
        _lib = lib
    return _lib


def bind_walks(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of ``csrc/traverse.cu`` (the walks, K4, the
    stack and instance bounds, the error string) on a library that holds
    it."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ptrt_max_stack.restype = i
    lib.ptrt_max_stack.argtypes = []
    lib.ptrt_error_string.restype = ctypes.c_char_p
    lib.ptrt_error_string.argtypes = [i]
    lib.ptrt_closest_hit.restype = i
    lib.ptrt_closest_hit.argtypes = ([p, i, p, i] + [p] * 8 + [i] + [p] * 5
                                     + [p, p])
    lib.ptrt_any_hit.restype = i
    lib.ptrt_any_hit.argtypes = [p, i, p, i] + [p] * 7 + [i, p, p, p]
    lib.ptrt_walk_counts.restype = i
    lib.ptrt_walk_counts.argtypes = ([i, p, i, p, i] + [p] * 7 + [i]
                                     + [p] * 6 + [p, p, p])
    lib.ptrt_walk_info.restype = i
    lib.ptrt_walk_info.argtypes = [i, p, p, p]
    lib.ptrt_max_instances.restype = i
    lib.ptrt_max_instances.argtypes = []
    lib.ptrt_instances_closest.restype = i
    lib.ptrt_instances_closest.argtypes = ([p, i, p, i] + [p] * 6 + [i]
                                           + [p] * 8 + [i, p, i, p, p])
    lib.ptrt_instances_any.restype = i
    lib.ptrt_instances_any.argtypes = ([p, i, p, i] + [p] * 7 + [i]
                                       + [p] * 3 + [i, p, i, p, p])
    lib.ptrt_instances_info.restype = i
    lib.ptrt_instances_info.argtypes = [i, i, i, p, p, p, p]
    return lib


def check(rc: int, name: str) -> None:
    if rc != 0:
        msg = get_lib().ptrt_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc} "
                           f"({msg})")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int,
                 device: torch.device) -> None:
    """Raise unless ``t`` is what a kernel takes: the given dtype, rank and
    device, and contiguous."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim}-D, got shape "
                         f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def scalar_ptr(name: str, v, device: torch.device) -> int:
    """The address of a one-element float32 tensor on ``device`` (a
    camera's value, which a kernel reads where it lies)."""
    if not (isinstance(v, torch.Tensor) and v.dtype == torch.float32
            and v.numel() == 1 and v.device == device):
        raise ValueError(f"{name}: expected a one-element float32 tensor on "
                         f"{device}, got {v!r}")
    return v.data_ptr()


def vec_ptrs(name: str, v, device: torch.device) -> tuple:
    """The three addresses of a Vec3 of one-element float32 tensors."""
    return tuple(scalar_ptr(f"{name}.{k}", getattr(v, k), device)
                 for k in "xyz")


def require_supported(device: torch.device) -> None:
    """Raise unless ``device`` is the CPU (the plain versions) or a card
    that is there (the kernels): a CUDA request without one is refused,
    never served by a plain version."""
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel or plain version for device {device}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{device}: no CUDA device here, and no kernel "
                           "runs without one")
