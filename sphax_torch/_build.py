"""Build and load the CUDA kernels (``csrc/*.cu``).

``nvcc`` compiles each of the repository's sources to an object, all of
them at once in parallel processes, and links them into one shared library
with a plain C interface, ``build/sphax_torch/libsphax_kernels_<sha>.so``
under the checkout (the name carries the sources' hash, so an edited source
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

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "window_kernels.cu", CSRC / "gravity_kernel.cu",
           CSRC / "rowpack.cu", CSRC / "cic.cu", CSRC / "rung_limit.cu")
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "sphax_torch"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
              "-v"]

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
    # the same with the P3M split scalars (device), G and cutoff^2 before
    # acc, du, stream
    "sphax_forces_grav": [_P, _P, _P, _I, _I, _I, _D, _D, _D, _I, _I, _P,
                          _D, _D, _P, _P, _P],
    # src [n, 4], n, eps^2, G, rows_per_thread, slices, cols_per_slice,
    # work [slices, 3, n], acc, stream
    "sphax_gravity": [_P, _I, _D, _D, _I, _I, _I, _P, _P, _P],
}
# the compact walks take c_lo, c_len in place of w_lo, w_nact, and cwidth
# right after group (before the first double)
_ARGTYPES.update({f"{k}_compact": v[:v.index(_D)] + [_I] + v[v.index(_D):]
                  for k, v in tuple(_ARGTYPES.items())
                  if k != "sphax_gravity"})
# the 2D and 1D instantiations of kernels A and C take the same arguments
_ARGTYPES.update({f"{k}{c}_{d}d": _ARGTYPES[f"{k}{c}"]
                  for k in ("sphax_solve_h_density", "sphax_forces")
                  for c in ("", "_compact") for d in (2, 1)})
# the derived pass's row gathers and packing (csrc/rowpack.cu): dim and
# the optional field's flag (and kernel C's sigma) after the sizes
_ARGTYPES.update({
    # pos, vel, mass, u, h, alpha, g, shift, n, Ns, dim, use_alpha, win,
    # h_s, u_s, alpha_s, stream
    "sphax_rowpack_gather_a": [_P] * 8 + [_I] * 4 + [_P] * 5,
    # win_a, src, h, rho, om, bf, P, cs, Ns, dim, use_bf, sigma, win, stream
    "sphax_rowpack_gather_c": [_P] * 8 + [_I] * 3 + [_D, _P, _P],
    # inv, h_s, rho_s, P_s, cs_s, om_s, du_s, divv_s, acc_s, n, dim, h, rho,
    # P, cs, om, du, divv, acc, stream
    "sphax_rowpack_scatter_out": [_P] * 9 + [_I] * 2 + [_P] * 9,
})
# the P3M mesh's CIC (csrc/cic.cu)
_ARGTYPES.update({
    # pos, mass, lo, cell, n, M, periodic, grid, stream
    "sphax_cic_deposit": [_P] * 4 + [_I] * 3 + [_P] * 2,
    # pos, lo, cell, grids, n, M, ngrids, periodic, out, stream
    "sphax_cic_interp": [_P] * 4 + [_I] * 4 + [_P] * 2,
})
# the block timesteps' limiter (csrc/rung_limit.cu)
_ARGTYPES.update({
    # g, is_real, shift, w_lo, w_nact, Ns, group, n, pos, h, mass, rung,
    # r_des, k, a, align, n_rungs, m_out, target, limited, stream
    "sphax_rung_limit_tick": [_P] * 5 + [_I] * 3 + [_P] * 5 + [_I] * 4
    + [_P] * 4,
    # g, is_real, shift, w_lo, w_nact, Ns, group, n, pos, h, mass, rung, a,
    # n_rungs, rung_out, stream
    "sphax_rung_limit_sync": [_P] * 5 + [_I] * 3 + [_P] * 4 + [_I] * 2
    + [_P] * 2,
})
# the source of each entry point, by the word after ``sphax_``
_SOURCE_OF = {"solve": "window_kernels.cu", "forces": "window_kernels.cu",
              "gravity": "gravity_kernel.cu", "rowpack": "rowpack.cu",
              "cic": "cic.cu", "rung": "rung_limit.cu"}


def cuda_tool(name: str):
    """The path of the CUDA toolkit's ``name`` (``nvcc``,
    ``compute-sanitizer``): under ``$CUDA_HOME/bin``, then on ``PATH``;
    None where neither has it."""
    from torch.utils.cpp_extension import CUDA_HOME

    cands = [os.path.join(CUDA_HOME, "bin", name)] if CUDA_HOME else []
    cands.append(shutil.which(name))
    return next((c for c in cands if c and os.path.exists(c)), None)


def _nvcc() -> str:
    nvcc = cuda_tool("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the CUDA kernels cannot be built")
    return nvcc


def library_path(sources=SOURCES) -> Path:
    h = hashlib.sha256()
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libsphax_kernels_{h.hexdigest()[:16]}.so"


def _run(cmd):
    """Start ``cmd``; the caller collects it with ``_wait``."""
    return cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)


def _wait(job) -> str:
    cmd, proc = job
    out, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{out}{err}")
    return err


def build(sources=SOURCES) -> Path:
    """Compile ``sources`` into one shared library, once per their hash,
    and return its path; BUILD_INFO records the build it made."""
    out = library_path(sources)
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        stem = f"{out.stem}.{os.getpid()}"
        objs = [out.with_name(f"{stem}.{src.stem}.o") for src in sources]
        tmp = out.with_name(f"{stem}.tmp.so")
        nvcc = _nvcc()
        t0 = time.perf_counter()
        jobs = [_run([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)])
                for src, o in zip(sources, objs)]
        ptxas = "".join([_wait(j) for j in jobs])
        _wait(_run([nvcc, *ARCH, "-shared", "-o", str(tmp),
                    *map(str, objs)]))
        os.replace(tmp, out)  # atomic: concurrent builders never load halves
        for o in objs:
            o.unlink()
        BUILD_INFO.update(seconds=time.perf_counter() - t0, ptxas=ptxas)
    return out


def open_library(path, sources=SOURCES) -> ctypes.CDLL:
    """Load a library built from ``sources`` and declare the types of the
    f32 and f64 entry points that they define."""
    names = {src.name for src in sources}
    lib = ctypes.CDLL(str(path))
    for base in _ARGTYPES:
        if _SOURCE_OF[base.split("_")[1]] not in names:
            continue
        for suffix in ("f32", "f64"):
            fn = getattr(lib, f"{base}_{suffix}")
            fn.argtypes = _ARGTYPES[base]
            fn.restype = ctypes.c_int
    lib.sphax_error_string.argtypes = [ctypes.c_int]
    lib.sphax_error_string.restype = ctypes.c_char_p
    return lib


def load() -> ctypes.CDLL:
    """Build (once per sources' hash) and load the kernel library."""
    global _lib
    if _lib is None:
        _lib = open_library(build())
    return _lib


def error_string(err: int) -> str:
    return f"{err} ({load().sphax_error_string(err).decode()})"
