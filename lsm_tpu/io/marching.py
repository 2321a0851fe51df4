"""Surface / contour extraction via the native C++ library.

Counterpart of the reference's mesh-export extensions
(``/root/reference/ext/MMGSurfaceExt.jl``, ``ext/MMGVolumeExt.jl``): the hot PDE
path stays on device; extraction and file export are host-side native code —
``native/marching.cpp`` compiled to ``liblsm_native.so`` (built on demand with
the repo Makefile) and called through ctypes.

- :func:`marching_tetrahedra` — triangle soup of ``{phi = iso}`` (3D).
- :func:`marching_squares` — contour segments of ``{phi = iso}`` (2D).
- :func:`weld_triangles` — deduplicate the soup into (vertices, faces).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from ..core.field import MeshField

__all__ = [
    "native_lib",
    "marching_tetrahedra",
    "marching_squares",
    "weld_triangles",
]

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_LIB_PATH = _NATIVE_DIR / "liblsm_native.so"
_lib = None


def native_lib() -> ctypes.CDLL:
    """Load (building if needed) the native helper library."""
    global _lib
    if _lib is not None:
        return _lib
    if not _LIB_PATH.exists():
        subprocess.run(
            ["make", "-C", str(_NATIVE_DIR)], check=True, capture_output=True
        )
    lib = ctypes.CDLL(str(_LIB_PATH))
    lib.lsm_marching_tets.restype = ctypes.c_int64
    lib.lsm_marching_tets.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.c_double,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
    ]
    lib.lsm_marching_squares.restype = ctypes.c_int64
    lib.lsm_marching_squares.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_double, ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
    ]
    lib.lsm_write_volume_mesh.restype = ctypes.c_int64
    lib.lsm_write_volume_mesh.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
    ]
    lib.lsm_write_surface_mesh.restype = ctypes.c_int64
    lib.lsm_write_surface_mesh.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
    ]
    lib.lsm_free.restype = None
    lib.lsm_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def _as_c(phi: MeshField):
    vals = np.ascontiguousarray(np.asarray(phi.values), dtype=np.float64)
    lo = np.asarray(phi.grid.lo, dtype=np.float64)
    h = np.asarray(phi.grid.spacing, dtype=np.float64)
    dp = ctypes.POINTER(ctypes.c_double)
    return vals, vals.ctypes.data_as(dp), lo.ctypes.data_as(dp), h.ctypes.data_as(dp)


def marching_tetrahedra(phi: MeshField, iso: float = 0.0) -> np.ndarray:
    """Triangle soup of the iso-surface: array ``(ntris, 3, 3)``."""
    if phi.ndim != 3:
        raise ValueError("marching_tetrahedra requires a 3D field")
    lib = native_lib()
    vals, pv, plo, ph = _as_c(phi)
    out = ctypes.POINTER(ctypes.c_double)()
    n = lib.lsm_marching_tets(pv, *vals.shape, plo, ph, float(iso), ctypes.byref(out))
    if n == 0:
        lib.lsm_free(out)
        return np.zeros((0, 3, 3))
    tris = np.ctypeslib.as_array(out, shape=(n, 3, 3)).copy()
    lib.lsm_free(out)
    return tris


def marching_squares(phi: MeshField, iso: float = 0.0) -> np.ndarray:
    """Contour segments of the iso-line: array ``(nsegs, 2, 2)``."""
    if phi.ndim != 2:
        raise ValueError("marching_squares requires a 2D field")
    lib = native_lib()
    vals, pv, plo, ph = _as_c(phi)
    out = ctypes.POINTER(ctypes.c_double)()
    n = lib.lsm_marching_squares(pv, *vals.shape, plo, ph, float(iso), ctypes.byref(out))
    if n == 0:
        lib.lsm_free(out)
        return np.zeros((0, 2, 2))
    segs = np.ctypeslib.as_array(out, shape=(n, 2, 2)).copy()
    lib.lsm_free(out)
    return segs


def weld_triangles(tris: np.ndarray, decimals: int = 9) -> Tuple[np.ndarray, np.ndarray]:
    """Deduplicate a triangle soup into ``(vertices (nv,3), faces (nt,3))``."""
    flat = tris.reshape(-1, 3)
    key = np.round(flat, decimals)
    verts, inverse = np.unique(key, axis=0, return_inverse=True)
    faces = inverse.reshape(-1, 3)
    # drop degenerate faces produced by welding
    ok = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    return verts, faces[ok]
