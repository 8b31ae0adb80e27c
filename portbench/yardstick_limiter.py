"""The yardstick of the timestep limiter's tick kernel
(``rung_limit_tick_kernel`` of ``sphax_torch/csrc/rung_limit.cu``):
operations per pair, bytes, and the closers and pairs a launch needs.

A launch's work is its closing rows': each closer tests its neighbours'
pairs (x_i - x_j on three axes, the squared distance, 2 max(h_i, h_j)
squared and the compare: 12 operations a pair, each counted 1, the rung's
min and the wake-up's compare left out), reads its position, h, mass, rung
and wanted rung once, and writes one rung. The pairs are those inside 2
max(h_i, h_j) of the final state (``yardstick.pair_counts``), a row's mean
taken for a closer's. The rows the kernel reads to find its closers, and
its walks' candidates outside the pairs, count as the kernel's own waste,
as the rows a window walk offers count in kernels A and C. The peaks and
the combination of bytes and operations are ``yardstick.py``'s.
"""
from __future__ import annotations

from portbench.yardstick import bound_ms

FLOPS = 12          # operations a pair of the neighbour test


def tick_op(name: str) -> bool:
    """True for a launch of the limiter's tick kernel."""
    return "rung_limit_tick" in name


def limiter_op(name: str) -> bool:
    """True for a launch of either of the limiter's kernels (the tick's, and
    the sync point's ``rung_limit_sync_kernel``)."""
    return "rung_limit" in name


def tick_bound(closers: float, pairs_per_row: float, dtype: str):
    """(ms, what binds) of one launch over ``closers`` closing rows with
    ``pairs_per_row`` neighbours each: the closers' position, h and mass in
    the state's precision and their rung and wanted rung (int32) in, one
    rung out; 12 operations a pair."""
    size = 8 if dtype == "float64" else 4
    nbytes = closers * (5 * size + 2 * 4 + 4)
    return bound_ms(nbytes, closers * pairs_per_row * FLOPS, dtype)
