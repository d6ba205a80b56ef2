"""The native 8-wide BVH builder, loaded with ctypes.

The source, ``bvh_builder.cpp`` beside this file, is the port's own copy of
the reference's builder, compiled with the reference's flags
(``g++ -O3 -fPIC -shared``) into the port's build directory, so both
packages build identical trees.
A Python build of a million-triangle scene would take minutes, so a failed
compile raises instead of falling back.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from ptrt_tpu_torch.build import build_shared_library

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "bvh_builder.cpp")

_lib = None
_build_lock = threading.Lock()


def get_lib() -> ctypes.CDLL:
    """Build (if needed) and load the library."""
    global _lib
    if _lib is None:
        path = build_shared_library(
            "libptrtnative.so", [SOURCE],
            ["g++", "-O3", "-fPIC", "-shared", SOURCE])
        lib = ctypes.CDLL(path)
        fp = ctypes.POINTER(ctypes.c_float)
        ip = ctypes.POINTER(ctypes.c_int32)
        lp = ctypes.POINTER(ctypes.c_int64)
        lib.ptrt_bvh8_build.restype = ctypes.c_int64
        lib.ptrt_bvh8_build.argtypes = [fp, fp, fp, ctypes.c_int64,
                                        ctypes.c_int32, lp, ip]
        lib.ptrt_bvh8_fetch.restype = None
        lib.ptrt_bvh8_fetch.argtypes = [fp, fp, ip, ip, ip, ip, lp]
        _lib = lib
    return _lib


def native_build_bvh8(tmin: np.ndarray, tmax: np.ndarray, cent: np.ndarray,
                      leaf_size: int):
    """Run the 8-wide builder.  Returns (slot_bmin (N,8,3), slot_bmax
    (N,8,3), child_base, leaf_base, leaf_count, int_count, order,
    max_depth)."""
    lib = get_lib()
    n = tmin.shape[0]
    tmin = np.ascontiguousarray(tmin, np.float32)
    tmax = np.ascontiguousarray(tmax, np.float32)
    cent = np.ascontiguousarray(cent, np.float32)
    order_len = ctypes.c_int64(0)
    max_depth = ctypes.c_int32(0)
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    # the library keeps the last build in a global until it is fetched
    with _build_lock:
        nw = lib.ptrt_bvh8_build(
            tmin.ctypes.data_as(fp), tmax.ctypes.data_as(fp),
            cent.ctypes.data_as(fp), n, leaf_size, ctypes.byref(order_len),
            ctypes.byref(max_depth))
        if nw <= 0:
            raise RuntimeError(f"native BVH8 build failed for {n} triangles")
        slot_bmin = np.empty((nw, 8, 3), np.float32)
        slot_bmax = np.empty((nw, 8, 3), np.float32)
        child_base = np.empty(nw, np.int32)
        leaf_base = np.empty(nw, np.int32)
        leaf_count = np.empty(nw, np.int32)
        int_count = np.empty(nw, np.int32)
        order = np.empty(order_len.value, np.int64)
        lib.ptrt_bvh8_fetch(
            slot_bmin.ctypes.data_as(fp), slot_bmax.ctypes.data_as(fp),
            child_base.ctypes.data_as(ip), leaf_base.ctypes.data_as(ip),
            leaf_count.ctypes.data_as(ip), int_count.ctypes.data_as(ip),
            order.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return (slot_bmin, slot_bmax, child_base, leaf_base, leaf_count,
            int_count, order, int(max_depth.value))
