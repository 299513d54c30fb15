"""ctypes bindings for the native C++ components (libpfemnative.so).

Build with `make -C pfemfort_jax/native` (g++ only, no external deps).
Every entry point has a pure-numpy fallback elsewhere in the package, so the
native library is an accelerator, not a requirement:
  * rcb_partition  -> parallel/partition.py:rcb_partition
  * greedy_partition -> parallel/partition.py:greedy_graph_partition
  * gen_tet_mesh   -> mesh/generate.py:box_tet (+ mesh/io.py:write_dat)
  * write_vtk      -> io/vtk.py:write_vtk
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

_LIB_PATH = os.path.join(os.path.dirname(__file__), "build",
                         "libpfemnative.so")
_lib = None


def load(path: Optional[str] = None):
    """Load (and cache) the native library; returns None if unavailable."""
    global _lib
    if _lib is not None:
        return _lib
    p = path or _LIB_PATH
    if not os.path.exists(p):
        return None
    lib = ctypes.CDLL(p)
    lib.pfem_rcb_partition.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_int32)]
    lib.pfem_greedy_partition.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int,
        ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32)]
    lib.pfem_edge_cut.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int,
        ctypes.c_int64, ctypes.c_int, ctypes.POINTER(ctypes.c_int32)]
    lib.pfem_edge_cut.restype = ctypes.c_int64
    lib.pfem_gen_tet_mesh.argtypes = [
        ctypes.c_double, ctypes.c_double, ctypes.c_int64,
        ctypes.c_double, ctypes.c_double, ctypes.c_int64,
        ctypes.c_double, ctypes.c_double, ctypes.c_int64, ctypes.c_char_p]
    lib.pfem_gen_tet_mesh.restype = ctypes.c_int
    try:
        lib.pfem_ell_pattern.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int64, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32)]
        lib.pfem_ell_pattern.restype = ctypes.c_int64
        lib.pfem_ic0.argtypes = [
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_double)]
        lib.pfem_ic0.restype = ctypes.c_int64
        lib.pfem_samg_aggregate.argtypes = [
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64)]
        lib.pfem_samg_aggregate.restype = ctypes.c_int64
    except AttributeError:      # stale .so from an older build
        pass
    _lib = lib
    return _lib


def ensure_built() -> bool:
    """Build the native library if missing (conftest does this for tests;
    bench/CLI callers use this).  Returns availability."""
    if available():
        return True
    import subprocess

    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    subprocess.run(["make", "-C", os.path.join(root, "pfemfort_jax",
                                               "native")],
                   check=False, capture_output=True)
    return available()


def available() -> bool:
    return load() is not None


def _ptr(a, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def rcb_partition(centroids: np.ndarray, nparts: int) -> np.ndarray:
    lib = load()
    assert lib is not None, "native library not built"
    c = np.ascontiguousarray(centroids, dtype=np.float64)
    n, dim = c.shape
    out = np.empty(n, dtype=np.int32)
    lib.pfem_rcb_partition(_ptr(c, ctypes.c_double), n, dim, nparts,
                           _ptr(out, ctypes.c_int32))
    return out


def greedy_partition(conn: np.ndarray, n_node: int, ncommon: int,
                     nparts: int) -> np.ndarray:
    lib = load()
    assert lib is not None, "native library not built"
    c = np.ascontiguousarray(conn, dtype=np.int32)
    n_elem, npe = c.shape
    out = np.empty(n_elem, dtype=np.int32)
    lib.pfem_greedy_partition(_ptr(c, ctypes.c_int32), n_elem, npe, n_node,
                              ncommon, nparts, _ptr(out, ctypes.c_int32))
    return out


def edge_cut(conn: np.ndarray, n_node: int, ncommon: int,
             part: np.ndarray) -> int:
    lib = load()
    assert lib is not None, "native library not built"
    c = np.ascontiguousarray(conn, dtype=np.int32)
    p = np.ascontiguousarray(part, dtype=np.int32)
    return int(lib.pfem_edge_cut(_ptr(c, ctypes.c_int32), c.shape[0],
                                 c.shape[1], n_node, ncommon,
                                 _ptr(p, ctypes.c_int32)))


def ell_pattern(elem_dof: np.ndarray, n_rows: int, lane_pad: int = 8):
    """CSR + padded-ELL pattern + sorted scatter plan from element DOF rows
    (the radix-sort pattern builder; assembly/pattern.py routes here).

    Returns (mat_perm, mat_segids, indptr, indices, ell_k, nnz) or None when
    unavailable / int32 ranges overflow (callers use the numpy builder)."""
    lib = load()
    if lib is None or not hasattr(lib, "pfem_ell_pattern"):
        return None
    ed = np.ascontiguousarray(elem_dof, dtype=np.int32)
    E, ns = ed.shape
    n_ent = E * ns * ns
    if n_ent >= 2**31:
        return None
    mat_perm = np.empty(n_ent, dtype=np.int32)
    mat_segids = np.empty(n_ent, dtype=np.int32)
    indptr = np.zeros(n_rows + 1, dtype=np.int64)
    indices = np.empty(max(n_ent, 1), dtype=np.int32)
    k_out = ctypes.c_int32(0)
    nnz = lib.pfem_ell_pattern(
        _ptr(ed, ctypes.c_int32), E, ns, n_rows, lane_pad,
        _ptr(mat_perm, ctypes.c_int32), _ptr(mat_segids, ctypes.c_int32),
        _ptr(indptr, ctypes.c_int64), _ptr(indices, ctypes.c_int32),
        ctypes.byref(k_out))
    if nnz < 0:
        return None
    return (mat_perm, mat_segids, indptr, indices[:nnz].copy(),
            int(k_out.value), int(nnz))


def ic0(indptr: np.ndarray, indices: np.ndarray, vals: np.ndarray):
    """In-place IC(0) on a lower-triangular CSR (diag last per row).
    Returns the pivot-fixup count, or None when unavailable."""
    lib = load()
    if lib is None or not hasattr(lib, "pfem_ic0"):
        return None
    lp = np.ascontiguousarray(indptr, dtype=np.int64)
    li = np.ascontiguousarray(indices, dtype=np.int32)
    assert vals.dtype == np.float64 and vals.flags.c_contiguous
    return int(lib.pfem_ic0(len(lp) - 1, _ptr(lp, ctypes.c_int64),
                            _ptr(li, ctypes.c_int32),
                            _ptr(vals, ctypes.c_double)))


def samg_aggregate(indptr: np.ndarray, indices: np.ndarray, n: int):
    """Greedy SA aggregation over a strength CSR; returns (agg, n_agg) or
    None when unavailable (solve/amg.py falls back to the python loop)."""
    lib = load()
    if lib is None or not hasattr(lib, "pfem_samg_aggregate"):
        return None
    sp = np.ascontiguousarray(indptr, dtype=np.int64)
    si = np.ascontiguousarray(indices, dtype=np.int32)
    agg = np.empty(n, dtype=np.int64)
    n_agg = int(lib.pfem_samg_aggregate(n, _ptr(sp, ctypes.c_int64),
                                        _ptr(si, ctypes.c_int32),
                                        _ptr(agg, ctypes.c_int64)))
    return agg, n_agg


def gen_tet_mesh(x0, x1, nex, y0, y1, ney, z0, z1, nez, prefix: str) -> None:
    lib = load()
    assert lib is not None, "native library not built"
    rc = lib.pfem_gen_tet_mesh(x0, x1, nex, y0, y1, ney, z0, z1, nez,
                               prefix.encode())
    if rc != 0:
        raise IOError(f"pfem_gen_tet_mesh failed writing {prefix}-*.dat")
