"""The yardstick of every kernel's bound on the H100: its peak rates and the
operations a pair of each kernel does. ``chip_smoke.py`` and
``sphax_torch.ab_kernels`` both take their bounds from here.

A kernel's bound is the larger of the bytes it must move (each input read
once, each output written once) over the memory rate and the operations it
does on these inputs over the peak rate of their type.
"""
from __future__ import annotations

import torch

# H100 SXM peaks (NVIDIA's data sheet): HBM bytes/s, non-tensor FLOP/s
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
# Operations per pair, counted off sphax_torch/csrc (an FMA is 2, a
# reciprocal square root, divide, exp or erfc 1): kernel A's Newton walk
# (3D, 2D, 1D) and its final walk with the Balsara sums, kernel C with the
# viscosity factor, C's gravity mode for each pair inside the cutoff and
# again for the pairs outside both supports (their acceleration update),
# and kernel G.
FLOPS = {"A_walk": {3: 31, 2: 28, 1: 25},
         "A_final_bals": {3: 59, 2: 43, 1: 32},
         "C": {3: 69, 2: 62, 1: 55}, "C_grav": 13, "C_grav_outside": 7,
         "G": 19}


def bound(nbytes, flops, dtype):
    """(ms, what binds): the larger of bytes over the memory rate and
    operations over the peak rate of ``dtype``."""
    t_b, t_f = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")


def gravity_bound(n, dtype):
    """Kernel G on N particles: [N, 3] positions and [N] masses read once,
    [N, 3] accelerations written once, N^2 pairs."""
    size = torch.tensor([], dtype=dtype).element_size()
    return bound(7 * n * size, FLOPS["G"] * n * n, dtype)
