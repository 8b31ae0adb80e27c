"""The yardstick of kernel C's gravity mode: operations per pair, bytes, and
the pairs a self-gravitating state needs.

Frozen copies (taken from commit 41ee4619647bc454680be4dd4c0f2ec1bd4ebb72):
the operations per pair of ``sphax_torch/bounds.py`` (counted off the CUDA
sources: an FMA is 2, a reciprocal square root, divide, exp or erfc 1) for
kernel C in 3D with the viscosity factor (``C``, each pair inside 2 max(h_i,
h_j)) and its gravity mode (``C_grav``, each pair inside the cutoff;
``C_grav_outside``, again each of those outside both supports, whose
acceleration update the mode adds alone), combined per launch as
``chip_smoke.kernel_bound`` combines them. The peaks and the combination
of bytes and operations are ``yardstick.py``'s. The bytes are the N
particles' inputs read once and outputs written once, whatever rows the
program's layout adds.
"""
from __future__ import annotations

import re

import torch

from portbench.reference import Grid
from portbench.yardstick import bound_ms

FLOPS = {"C": 69, "C_grav": 13, "C_grav_outside": 7}   # 3D, per pair

# kernel C's launches: a ``forces..._kernel`` template whose last argument,
# GRAV, is true (``csrc/window_kernels.cu``)
_C = re.compile(r"forces\w*_kernel<([^<>]*)>")
# the device operations of the P3M mesh (``pm.mesh_accel``), by name, taken
# from a traced step of cloud256.p3m: cuFFT's kernels, the deposit's
# scatter-add and the complex arithmetic of the k-space solve. None
# matches an operation of a traced turb256.fixed step; the mesh's integer
# and real elementwise work and its gathers take kernels that the rest of
# the step takes too, and are left out
MESH = ("fft", "indexFuncLargeIndex", "c10::complex")


def grav_c(name: str) -> bool:
    """True for a launch of kernel C's gravity mode."""
    m = _C.search(name)
    return bool(m) and m.group(1).split(",")[-1].strip() == "true"


def mesh_op(name: str) -> bool:
    """True for a device operation of the P3M mesh."""
    return any(p in name for p in MESH)


def device_ms(run, pick):
    """(device ms, launches) of the traced window's operations whose name
    ``pick`` takes; None without a trace."""
    t = run.trace
    if t is None or not t.device:
        return None
    ops = [(t1 - t0) / 1e3 for name, t0, t1 in t.device if pick(name)]
    return sum(ops), len(ops)


def kernel_c_grav(n: int, pairs_c: int, pairs_cut: int, dtype: str):
    """One launch of kernel C's gravity mode on N particles: pos, vel,
    mass, h, rho, P, cs, Omega and the viscosity factor in; acc and du/dt
    out; the pairs inside 2 max(h_i, h_j) and the pairs inside the cutoff,
    the self pair excluded from both."""
    size = 8 if dtype == "float64" else 4
    flops = (pairs_c * FLOPS["C"] + pairs_cut * FLOPS["C_grav"]
             + max(pairs_cut - pairs_c, 0) * FLOPS["C_grav_outside"])
    return bound_ms((13 + 4) * n * size, flops, dtype)


def pair_counts(pos, h, cutoff: float, box: float = 1.0,
                block: int = 16384):
    """(pairs inside 2 h_i, self included; pairs inside 2 max(h_i, h_j),
    self excluded; pairs with 0 < r <= cutoff), summed over all rows of the
    periodic box, counted in blocks of rows on a cell list at the cutoff
    (every h is at most half of it)."""
    pos = pos.double()
    h = h.double()
    grid = Grid(torch.remainder(pos, box), cutoff * (1.0 + 1e-9), box,
                block=block)
    n = pos.shape[0]
    a = c = g = 0
    rows_all = torch.arange(n, device=pos.device)
    for b0 in range(0, n, block * 4):
        i, j, _, r = grid.pairs(rows_all[b0:b0 + block * 4])
        hi = h[i + b0]
        a += int((r < 2.0 * hi).sum())
        c += int(((r < 2.0 * torch.maximum(hi, h[j])) & (r > 0)).sum())
        g += int(((r > 0) & (r <= cutoff)).sum())
    return a, c, g


def cutoff(run) -> float:
    """The window's cutoff the configuration states: 2 cutoff_scale h_margin
    eta / n_side, n_side from the run's particle count."""
    w = run.config["window"]
    n_side = round(run.n ** (1.0 / 3.0))
    return (2.0 * w["cutoff_scale"] * w["h_margin"] * float(
        run.config["ics"]["eta"]) / n_side)


def pairs(run):
    """``pair_counts`` of the run's final state at the configuration's
    cutoff, counted once a run."""
    got = getattr(run, "pairs_grav", None)
    if got is None:
        got = pair_counts(*run.final, cutoff(run))
        run.pairs_grav = got
    return got
