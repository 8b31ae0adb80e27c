"""The yardstick of the rooflines: peaks, operations per pair, bytes, and
the pairs a state needs.

Frozen copies (see README.md for the commit they were taken from): the
H100 SXM peaks and the operations per pair of ``sphax_torch/bounds.py``
(counted off the CUDA sources: an FMA is 2, a reciprocal square root,
divide, exp or erfc 1), combined per launch as ``chip_smoke.kernel_bound``
combines them. The bytes are the benchmark's own: the N particles' inputs
read once and outputs written once, whatever rows the program's layout
adds, so a roofline reads the same work whatever implements it.
"""
from __future__ import annotations

import torch

from portbench.reference import Grid

PEAK_BYTES = 3.35e12                       # HBM3, bytes/s
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}   # non-tensor FLOP/s
FLOPS = {"A_walk": 31, "A_final_bals": 59, "C": 69}  # 3D, per pair


def bound_ms(nbytes: float, flops: float, dtype: str):
    """(ms, what binds): the larger of bytes over the memory rate and
    operations over the peak rate of ``dtype``."""
    t_b, t_f = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")


def kernel_a(n: int, pairs: int, iters: int, balsara: bool, dtype: str):
    """One launch of kernel A on N particles: pos, mass, h0 (and vel with
    the Balsara sums) in; h, rho, d rho/d h (and the div and curl sums)
    out; ``iters`` Newton walks and the final walk over the pairs inside
    2 h_i."""
    size = 8 if dtype == "float64" else 4
    per = iters * FLOPS["A_walk"] + (FLOPS["A_final_bals"] if balsara
                                     else FLOPS["A_walk"])
    floats = (5 + (3 if balsara else 0)) + (3 + (2 if balsara else 0))
    return bound_ms(floats * n * size, pairs * per, dtype)


def kernel_c(n: int, pairs: int, balsara: bool, dtype: str):
    """One launch of kernel C on N particles: pos, vel, mass, h, rho, P,
    cs, Omega (and the viscosity factor) in; acc and du/dt out; the pairs
    inside 2 max(h_i, h_j) other than the self pair."""
    size = 8 if dtype == "float64" else 4
    floats = 12 + (1 if balsara else 0) + 4
    flops = pairs * (FLOPS["C"] - (0 if balsara else 3))
    return bound_ms(floats * n * size, flops, dtype)


def pair_counts(pos, h, box: float = 1.0, block: int = 16384):
    """(pairs inside 2 h_i, self included; pairs inside 2 max(h_i, h_j),
    self excluded), summed over all rows of the periodic box, counted in
    blocks of rows on a cell list."""
    pos = pos.double()
    h = h.double()
    radius = 2.0 * float(h.max()) * (1.0 + 1e-9)
    grid = Grid(torch.remainder(pos, box), radius, box, block=block)
    n = pos.shape[0]
    a = c = 0
    rows_all = torch.arange(n, device=pos.device)
    for b0 in range(0, n, block * 4):
        i, j, _, r = grid.pairs(rows_all[b0:b0 + block * 4])
        hi = h[i + b0]
        a += int((r < 2.0 * hi).sum())
        c += int(((r < 2.0 * torch.maximum(hi, h[j])) & (r > 0)).sum())
    return a, c
