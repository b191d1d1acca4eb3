"""ctypes bridge to the C++ binned-SAH BVH build (``native/``).

The port's own copy of ``light_transport_tpu.accel.native``: it loads
``native/liblt_native.so`` (running ``make`` there first if the library is
missing) and raises when it cannot; ``accel.bvh.build`` then uses the
numpy build.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_LIB_PATH = _NATIVE_DIR / "liblt_native.so"

_lib = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        if not _LIB_PATH.exists():
            subprocess.run(["make", "-s", "-C", str(_NATIVE_DIR)], check=True,
                           capture_output=True, timeout=120)
        lib = ctypes.CDLL(str(_LIB_PATH))
        dp, ip = ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32)
        lib.lt_build_bvh.restype = ctypes.c_int64
        lib.lt_build_bvh.argtypes = [
            dp, dp, dp, ctypes.c_int64, ctypes.c_int32,  # lo hi centroid t leaf
            dp, dp, ip, ip, ip, ip,  # out min max right first count axis
            ctypes.POINTER(ctypes.c_int64),  # order
        ]
        _lib = lib
    return _lib


def build_native(verts: np.ndarray, centroid: np.ndarray, max_leaf: int):
    """Same contract as ``accel.bvh._build_host``."""
    lib = _load()
    t = verts.shape[0]
    lo = np.ascontiguousarray(verts.min(axis=1), np.float64)
    hi = np.ascontiguousarray(verts.max(axis=1), np.float64)
    centroid = np.ascontiguousarray(centroid, np.float64)
    cap = 2 * t
    out_min = np.empty((cap, 3), np.float64)
    out_max = np.empty((cap, 3), np.float64)
    ints = [np.empty((cap,), np.int32) for _ in range(4)]
    order = np.arange(t, dtype=np.int64)

    def p(a, ty):
        return a.ctypes.data_as(ctypes.POINTER(ty))

    m = lib.lt_build_bvh(
        p(lo, ctypes.c_double), p(hi, ctypes.c_double),
        p(centroid, ctypes.c_double), t, max_leaf,
        p(out_min, ctypes.c_double), p(out_max, ctypes.c_double),
        *(p(a, ctypes.c_int32) for a in ints), p(order, ctypes.c_int64))
    if m <= 0:
        raise RuntimeError(f"native BVH build failed: {m}")
    return (out_min[:m], out_max[:m], *(a[:m] for a in ints), order)
