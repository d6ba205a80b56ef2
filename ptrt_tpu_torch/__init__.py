"""ptrt_tpu_torch — the path-tracing engine on PyTorch and CUDA.

A port of ``ptrt_tpu`` (the JAX package beside it, which stays the
reference) to one NVIDIA H100.  The module layout mirrors the reference:
``core/``, ``geometry/``, ``scene/``, ``render/``, ``app/``; ``tools/``
holds probes that run as modules.  Plain work is
eager torch on explicit devices; the hot paths are hand-written CUDA
kernels in ``csrc/`` (built at first use by ``kernels.py``), each with a
plain torch version that CPU tensors run.  This package never imports JAX
or ``ptrt_tpu``; it reads two reference files by path (the blue-noise table
and the native BVH builder's source).
"""

__version__ = "0.1.0"
