"""Native (C++) host-side kernels with graceful Python fallback.

The device compute path is JAX/XLA; this package provides the native
counterpart of the reference's C++ host-side preprocessing (remap/
topology construction, ``fea/mesh_template.h:19-161``,
``fea/mesh.cpp:27-57``).  The shared object is not part of the source
tree: it is compiled from ``mesh_kernels.cpp`` with g++ on first use on
each machine (no external dependencies) and written atomically, so
concurrent processes never load a half-written file.  If compilation is
impossible, one line says so and the pure Python builders in
:mod:`sanm_tpu.fea.remap` are used instead.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "mesh_kernels.cpp")
_SO = os.path.join(_HERE, "_mesh_kernels.so")
_lock = threading.Lock()
_lib = None
_tried = False


def _build():
    """Compile to a temporary file beside the target, then rename it
    into place: the rename is atomic, so parallel test workers that
    build at once each load a complete library."""
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_HERE)
    os.close(fd)
    try:
        cmd = [
            "g++", "-O3", "-march=native", "-shared", "-fPIC",
            "-std=c++17", _SRC, "-o", tmp,
        ]
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _SO)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def get_lib():
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            if not os.path.exists(_SO) or (
                os.path.getmtime(_SO) < os.path.getmtime(_SRC)
            ):
                _build()
            lib = ctypes.CDLL(_SO)
            i32p = ctypes.POINTER(ctypes.c_int32)
            i64p = ctypes.POINTER(ctypes.c_int64)
            u8p = ctypes.POINTER(ctypes.c_uint8)
            f64p = ctypes.POINTER(ctypes.c_double)
            i64 = ctypes.c_int64

            lib.number_unknowns.restype = i64
            lib.number_unknowns.argtypes = [i64, u8p, i32p, i32p]
            lib.build_shape_remap.restype = None
            lib.build_shape_remap.argtypes = [
                i64, i64, i32p, i32p, f64p, f64p, i64, i32p, f64p, f64p,
            ]
            lib.vertex_adjacency.restype = None
            lib.vertex_adjacency.argtypes = [
                i64, i64, i32p, i32p, i32p, i32p, i32p,
            ]
            lib.force_remap_count.restype = i64
            lib.force_remap_count.argtypes = [i64, i64, i32p, i32p, i32p,
                                              i64p]
            lib.build_force_remap.restype = None
            lib.build_force_remap.argtypes = [
                i64, i64, i32p, i32p, i32p, i32p, f64p, i32p, f64p,
            ]
            lib.transpose_count.restype = i64
            lib.transpose_count.argtypes = [i64, i64, i32p, f64p, i64, i32p]
            lib.transpose_fill.restype = None
            lib.transpose_fill.argtypes = [
                i64, i64, i32p, f64p, i64, i64, i32p, f64p,
            ]
            _lib = lib
        except Exception as e:
            print("sanm_tpu.native: C++ mesh kernels unavailable (%s); "
                  "using the Python builders" % type(e).__name__,
                  file=sys.stderr)
            _lib = None
        return _lib


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def build_shape_remap_native(tets, fixed_mask, init_coords, vtx_delta):
    """Native ShapeMatRemap arrays; returns None if the lib is missing.

    Returns (idx (T*9,3) int32, coef, bias (T,3,3), x0 (n,),
    vertex_loc (n,2), vtx2uidx (V,3), n_unknown)."""
    lib = get_lib()
    if lib is None:
        return None
    tets = np.ascontiguousarray(tets, np.int32)
    V = fixed_mask.shape[0]
    T = tets.shape[0]
    fixed = np.ascontiguousarray(fixed_mask, np.uint8)
    init = np.ascontiguousarray(init_coords, np.float64)
    vtx2uidx = np.empty((V, 3), np.int32)
    vertex_loc = np.empty((V * 3, 2), np.int32)
    n = lib.number_unknowns(
        V, _ptr(fixed, ctypes.c_uint8), _ptr(vtx2uidx, ctypes.c_int32),
        _ptr(vertex_loc, ctypes.c_int32),
    )
    vertex_loc = vertex_loc[:n].copy()
    idx = np.empty((T * 9, 3), np.int32)
    coef = np.empty((T * 9, 3), np.float64)
    bias = np.empty((T, 3, 3), np.float64)
    if vtx_delta is not None:
        delta = np.ascontiguousarray(vtx_delta, np.float64)
        dptr = _ptr(delta, ctypes.c_double)
    else:
        dptr = ctypes.cast(None, ctypes.POINTER(ctypes.c_double))
    lib.build_shape_remap(
        T, V, _ptr(tets, ctypes.c_int32), _ptr(vtx2uidx, ctypes.c_int32),
        _ptr(init, ctypes.c_double), dptr, n,
        _ptr(idx, ctypes.c_int32), _ptr(coef, ctypes.c_double),
        _ptr(bias, ctypes.c_double),
    )
    x0 = init.reshape(-1)[vtx2uidx.reshape(-1) >= 0].copy()
    return idx, coef, bias, x0, vertex_loc, vtx2uidx, int(n)


def build_force_remap_native(tets, nV, norms, vertex_loc):
    """Native ForceOutputRemap padded arrays; None if lib missing."""
    lib = get_lib()
    if lib is None:
        return None
    tets = np.ascontiguousarray(tets, np.int32)
    T = tets.shape[0]
    n = vertex_loc.shape[0]
    deg = np.empty(nV, np.int32)
    adj_start = np.empty(nV + 1, np.int32)
    adj_tet = np.empty(4 * T, np.int32)
    adj_slot = np.empty(4 * T, np.int32)
    lib.vertex_adjacency(
        T, nV, _ptr(tets, ctypes.c_int32), _ptr(deg, ctypes.c_int32),
        _ptr(adj_start, ctypes.c_int32), _ptr(adj_tet, ctypes.c_int32),
        _ptr(adj_slot, ctypes.c_int32),
    )
    vloc = np.ascontiguousarray(vertex_loc, np.int32)
    counts = np.empty(n, np.int64)
    W = lib.force_remap_count(
        T, n, _ptr(tets, ctypes.c_int32), _ptr(vloc, ctypes.c_int32),
        _ptr(deg, ctypes.c_int32), _ptr(counts, ctypes.c_int64),
    )
    norms_c = np.ascontiguousarray(norms, np.float64)
    idx = np.empty((n, W), np.int32)
    coef = np.empty((n, W), np.float64)
    lib.build_force_remap(
        n, W, _ptr(vloc, ctypes.c_int32), _ptr(adj_start, ctypes.c_int32),
        _ptr(adj_tet, ctypes.c_int32), _ptr(adj_slot, ctypes.c_int32),
        _ptr(norms_c, ctypes.c_double), _ptr(idx, ctypes.c_int32),
        _ptr(coef, ctypes.c_double),
    )
    return idx, coef


def transpose_padded_native(idx, coef, inp_size):
    """Native transposed padding; None if lib missing."""
    lib = get_lib()
    if lib is None:
        return None
    idx = np.ascontiguousarray(idx, np.int32)
    coef = np.ascontiguousarray(coef, np.float64)
    n_rows, W = idx.shape
    counts = np.empty(inp_size, np.int32)
    TW = lib.transpose_count(
        n_rows, W, _ptr(idx, ctypes.c_int32), _ptr(coef, ctypes.c_double),
        inp_size, _ptr(counts, ctypes.c_int32),
    )
    tidx = np.empty((inp_size, TW), np.int32)
    tcoef = np.empty((inp_size, TW), np.float64)
    lib.transpose_fill(
        n_rows, W, _ptr(idx, ctypes.c_int32), _ptr(coef, ctypes.c_double),
        inp_size, TW, _ptr(tidx, ctypes.c_int32),
        _ptr(tcoef, ctypes.c_double),
    )
    return tidx, tcoef
