"""The yardstick of the 2D rooflines: operations per pair at D = 2, bytes,
and the pairs a 2D state needs.

Frozen copies (taken from commit ffe4fbee259d64ecd4c4154f2fdd09935af8f99b):
the 2D operations per pair of ``sphax_torch/bounds.py`` (counted off the
CUDA sources: an FMA is 2, a reciprocal square root, divide, exp or erfc
1). The peaks and the combination per launch are ``yardstick.py``'s. The
bytes are the N particles' inputs read once and outputs written once at
D = 2, whatever rows the program's layout adds.
"""
from __future__ import annotations

import torch

from portbench.reference_kh2d import Grid
from portbench.yardstick import bound_ms

FLOPS = {"A_walk": 28, "A_final_bals": 43, "C": 62}   # 2D, per pair


def kernel_a(n: int, pairs: int, iters: int, dtype: str):
    """One launch of kernel A on N particles with the Balsara sums: pos (2),
    mass, h0 and vel (2) in; h, rho, d rho/d h and the div and curl sums
    out; ``iters`` Newton walks and the final walk over the pairs inside
    2 h_i."""
    size = 8 if dtype == "float64" else 4
    per = iters * FLOPS["A_walk"] + FLOPS["A_final_bals"]
    return bound_ms((6 + 5) * n * size, pairs * per, dtype)


def kernel_c(n: int, pairs: int, dtype: str):
    """One launch of kernel C on N particles with the viscosity factor: pos
    (2), vel (2), mass, h, rho, P, cs, Omega and the factor in; acc (2) and
    du/dt out; the pairs inside 2 max(h_i, h_j) other than the self pair."""
    size = 8 if dtype == "float64" else 4
    return bound_ms((11 + 3) * n * size, pairs * FLOPS["C"], dtype)


def pair_counts(pos, h, box: float = 1.0, block: int = 16384):
    """(pairs inside 2 h_i, self included; pairs inside 2 max(h_i, h_j),
    self excluded), summed over all rows of the periodic square, counted
    in blocks of rows on a cell list."""
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


def pairs(run):
    """``pair_counts`` of the run's final state, counted once a run."""
    got = getattr(run, "pairs_2d", None)
    if got is None:
        got = pair_counts(*run.final)
        run.pairs_2d = got
    return got
