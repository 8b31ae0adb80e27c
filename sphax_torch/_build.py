"""Build and load the CUDA window kernels (``csrc/window_kernels.cu``).

``nvcc`` compiles the repository's own source into a shared library with a
plain C interface, ``build/sphax_torch/libsphax_kernels_<sha>.so`` under
the checkout (the name carries the source's hash, so an edited source
rebuilds), at the first call that needs it; ``ctypes`` loads it. Importing
this module builds nothing, so the package imports on a machine without
``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "csrc" / "window_kernels.cu"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "sphax_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None
# filled by the build that made the library in this process
BUILD_INFO = {"seconds": None, "ptxas": ""}

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_ARGTYPES = {
    # win, h0, w_lo, w_nact, n_sorted, tile, group, sig, eta_d, hcap, iters,
    # bals, h, rho, drho_dh, div_sum, curl_mag, stream
    "sphax_solve_h_density": [_P, _P, _P, _P, _I, _I, _I, _D, _D, _D, _I,
                              _I, _P, _P, _P, _P, _P, _P],
    # win, w_lo, w_nact, n_sorted, tile, group, alpha, beta, eps, use_bf,
    # fast, acc, du, stream
    "sphax_forces": [_P, _P, _P, _I, _I, _I, _D, _D, _D, _I, _I, _P, _P,
                     _P],
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cands = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    cands.append(shutil.which("nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA window kernels cannot be built")


def library_path() -> Path:
    sha = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libsphax_kernels_{sha}.so"


def load() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _lib
    if _lib is not None:
        return _lib
    out = library_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: concurrent builders never load halves
        BUILD_INFO.update(seconds=time.perf_counter() - t0,
                          ptxas=proc.stderr)
    lib = ctypes.CDLL(str(out))
    for base, argtypes in _ARGTYPES.items():
        for suffix in ("f32", "f64"):
            fn = getattr(lib, f"{base}_{suffix}")
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    lib.sphax_error_string.argtypes = [ctypes.c_int]
    lib.sphax_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def error_string(err: int) -> str:
    return f"{err} ({load().sphax_error_string(err).decode()})"
