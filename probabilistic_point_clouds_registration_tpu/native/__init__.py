"""Native C++ host-runtime kernels (ctypes bindings with pure-Python fallback).

The reference's host runtime is C++ throughout (PCL PCD codec, VoxelGrid —
src/prob_point_cloud_registration_ex.cc:111-136, prob_point_cloud_registration.cc:24-41).
This package provides the framework's equivalents: an LZF codec for PCD
``binary_compressed`` bodies and a hash-grid voxel downsample, compiled from
``pcr_native.cpp`` on first use (g++, cached next to the source) and loaded
via ctypes. Every entry point has a numpy/Python fallback so the framework
works without a toolchain; the callers in io/pcd.py and ops/voxel.py pick the
native path automatically when it is available.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).with_name("pcr_native.cpp")
_LIB_PATH = Path(__file__).with_name("libpcr_native.so")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    cmd = [
        "g++", "-O3", "-shared", "-fPIC", "-std=c++17",
        str(_SRC), "-o", str(_LIB_PATH),
    ]
    try:
        res = subprocess.run(cmd, capture_output=True, timeout=120)
        return res.returncode == 0 and _LIB_PATH.exists()
    except (OSError, subprocess.TimeoutExpired):
        return False


def load() -> Optional[ctypes.CDLL]:
    """Return the native library, building it on first call; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("PCR_DISABLE_NATIVE"):
            return None
        if not _LIB_PATH.exists() or _LIB_PATH.stat().st_mtime < _SRC.stat().st_mtime:
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(str(_LIB_PATH))
        except OSError:
            return None
        lib.pcr_lzf_decompress.restype = ctypes.c_int
        lib.pcr_lzf_decompress.argtypes = [
            ctypes.c_char_p, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint64,
        ]
        lib.pcr_lzf_compress.restype = ctypes.c_uint64
        lib.pcr_lzf_compress.argtypes = [
            ctypes.c_char_p, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint64,
        ]
        lib.pcr_voxel_downsample.restype = ctypes.c_int64
        lib.pcr_voxel_downsample.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_double,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64),
        ]
        lib.pcr_dilate_cells.restype = ctypes.c_int64
        lib.pcr_dilate_cells.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def lzf_decompress(data: bytes, expected_size: int) -> Optional[bytes]:
    """Native LZF decompress; None if the library is unavailable.

    Raises ValueError on a corrupt stream (same contract as the Python codec).
    """
    lib = load()
    if lib is None:
        return None
    out = np.empty(expected_size, dtype=np.uint8)
    rc = lib.pcr_lzf_decompress(
        data, len(data),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), expected_size,
    )
    if rc != 0:
        raise ValueError(f"corrupt LZF stream (native rc={rc})")
    return out.tobytes()


def lzf_compress(data: bytes) -> Optional[bytes]:
    """Native LZF compress; None if unavailable or incompressible."""
    lib = load()
    if lib is None or len(data) == 0:
        return None
    cap = len(data) + len(data) // 16 + 64
    out = np.empty(cap, dtype=np.uint8)
    size = lib.pcr_lzf_compress(
        data, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap
    )
    if size == 0:
        return None
    return out[:size].tobytes()


def dilate_cells(
    cell_ids: np.ndarray, dims: np.ndarray, counts: np.ndarray
) -> Optional[tuple]:
    """Native occupied-cell dilation (the per-pair prepack's host half).

    Returns (d_cells_e, nrows, union) in stable descending-union order —
    byte-identical to the numpy body of ops.fused_grid.dilate_cells_host —
    or None when the library is unavailable or the grid exceeds the int32
    id space (callers fall back to numpy).
    """
    lib = load()
    if lib is None:
        return None
    ids = np.ascontiguousarray(cell_ids, dtype=np.int64)
    dims64 = np.ascontiguousarray(dims, dtype=np.int64)
    cnt = np.ascontiguousarray(counts, dtype=np.int32)
    u = ids.shape[0]
    prod_e = int((dims64 + 4).prod())
    ud_cap = min(27 * u, prod_e)
    # np.empty is virtual until touched; only the UD rows written get pages.
    d_cells_e = np.empty(ud_cap, dtype=np.int32)
    nrows = np.empty((ud_cap, 27), dtype=np.int32)
    union = np.empty(ud_cap, dtype=np.int32)
    p32 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    ud = lib.pcr_dilate_cells(
        ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), u,
        dims64.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), p32(cnt),
        ud_cap, p32(d_cells_e), p32(nrows), p32(union),
    )
    if ud < 0:
        return None
    return d_cells_e[:ud].copy(), nrows[:ud].copy(), union[:ud].copy()


def voxel_downsample(points: np.ndarray, leaf_size: float) -> Optional[np.ndarray]:
    """Native hash-grid centroid downsample; None if unavailable.

    Output matches ops/voxel.py: centroids ordered by ascending linear voxel
    index (PCL's ordering).
    """
    lib = load()
    if lib is None:
        return None
    pts = np.ascontiguousarray(points, dtype=np.float64)
    n = pts.shape[0]
    out = np.empty((n, 3), dtype=np.float64)
    keys = np.empty(n, dtype=np.int64)
    m = lib.pcr_voxel_downsample(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n, float(leaf_size),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        keys.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if m < 0:
        return None
    order = np.argsort(keys[:m], kind="stable")
    return out[:m][order].astype(points.dtype)
