"""Build and load the package's CUDA kernels.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` into a shared library with
a plain C interface and loaded with ctypes.  The library lands in
``light_transport_tpu_torch/_build/`` under a name hashed from the source
and the flags, so an edited source rebuilds on its next use and an
unchanged one loads at once.  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas=-v")

_loaded: dict = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").exists():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA "
                           "kernels are built from csrc/ at first use")
    return found


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library of the same source and
    flags exists; returns the library's path.  The compiler's report
    (registers, spills and shared memory per kernel) is kept beside it as
    ``<library>.log``."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"{name}_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}"
                           f"\n{res.stdout}\n{res.stderr}")
    Path(str(out) + ".log").write_text(res.stdout + res.stderr)
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


def load_photon_kernel() -> ctypes.CDLL:
    """The photon-block library, built on first use and bound once."""
    lib = _loaded.get("photon_kernel")
    if lib is None:
        lib = ctypes.CDLL(str(build("photon_kernel")))
        vp = ctypes.c_void_p
        lib.photon_block_launch.argtypes = [vp] * 20
        lib.photon_block_launch.restype = ctypes.c_int
        lib.photon_block_residency.argtypes = [vp, vp]
        lib.photon_block_residency.restype = ctypes.c_int
        lib.photon_kernel_error_string.argtypes = [ctypes.c_int]
        lib.photon_kernel_error_string.restype = ctypes.c_char_p
        _loaded["photon_kernel"] = lib
    return lib


def load_intersect_kernel() -> ctypes.CDLL:
    """The intersector library (K3, the cull and K4), built on first use
    and bound once."""
    lib = _loaded.get("intersect_kernel")
    if lib is None:
        lib = ctypes.CDLL(str(build("intersect_kernel")))
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.intersect_dense_launch.argtypes = [vp] * 5 + [i] * 4 + [vp] * 2
        lib.intersect_dense_launch.restype = ctypes.c_int
        lib.intersect_dense_blocks_per_sm.argtypes = [i, vp]
        lib.intersect_dense_blocks_per_sm.restype = ctypes.c_int
        lib.tile_cull_launch.argtypes = [vp] * 4 + [i] * 2 + [vp] * 4
        lib.tile_cull_launch.restype = ctypes.c_int
        lib.intersect_gather_launch.argtypes = [vp] * 7 + [i] * 4 + [vp] * 3
        lib.intersect_gather_launch.restype = ctypes.c_int
        lib.intersect_gather_blocks_per_sm.argtypes = [i, vp]
        lib.intersect_gather_blocks_per_sm.restype = ctypes.c_int
        lib.intersect_kernel_error_string.argtypes = [ctypes.c_int]
        lib.intersect_kernel_error_string.restype = ctypes.c_char_p
        _loaded["intersect_kernel"] = lib
    return lib


def bind_treelet_kernel(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the treelet library's C functions on ``lib``."""
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.treelet_walk_launch.argtypes = [vp, i, vp, vp] + [i] * 4 + [vp] * 5
    lib.treelet_walk_launch.restype = ctypes.c_int
    lib.treelet_resume_launch.argtypes = ([vp, i, vp, vp, vp] + [i] * 6
                                          + [vp] * 8)
    lib.treelet_resume_launch.restype = ctypes.c_int
    lib.treelet_blocks_per_sm.argtypes = [i, vp]
    lib.treelet_blocks_per_sm.restype = ctypes.c_int
    lib.treelet_kernel_error_string.argtypes = [ctypes.c_int]
    lib.treelet_kernel_error_string.restype = ctypes.c_char_p
    return lib


def load_treelet_kernel() -> ctypes.CDLL:
    """The treelet-walk library (K5 and K5r), built on first use and bound
    once."""
    lib = _loaded.get("treelet_kernel")
    if lib is None:
        lib = bind_treelet_kernel(ctypes.CDLL(str(build("treelet_kernel"))))
        _loaded["treelet_kernel"] = lib
    return lib


# the probe library's launch functions and their tensor operands (each
# also takes the output and the stream)
PROBE_OPERANDS = {"p_while": 1, "p_while_vec_carry": 1, "p_dma_smem": 2,
                  "p_red_when": 1, "p_red_dma": 2, "p_red_smem_dma": 2,
                  "p_onehot": 2, "p_when_mm": 2, "p_reshape_8x128": 1,
                  "p_packed_pair_flush": 3}


def load_probe_kernels() -> ctypes.CDLL:
    """The feature-probe library (P1-P10 and an empty kernel), built on
    first use and bound once."""
    lib = _loaded.get("probe_kernels")
    if lib is None:
        lib = ctypes.CDLL(str(build("probe_kernels")))
        vp = ctypes.c_void_p
        for name, n in PROBE_OPERANDS.items():
            fn = getattr(lib, f"{name}_launch")
            fn.argtypes = [vp] * (n + 2)
            fn.restype = ctypes.c_int
        lib.probe_empty_launch.argtypes = [vp]
        lib.probe_empty_launch.restype = ctypes.c_int
        lib.probe_kernel_error_string.argtypes = [ctypes.c_int]
        lib.probe_kernel_error_string.restype = ctypes.c_char_p
        _loaded["probe_kernels"] = lib
    return lib
