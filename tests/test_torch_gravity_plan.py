"""The launch plan of the CUDA kernel G, held on the CPU.

``direct_gravity.gravity_plan(n, sm_count)`` cuts a launch into row blocks
(each thread owns ``rows_per_thread`` rows t, t + threads, ... of its
block) and column slices of whole tiles. The kernel trusts it for coverage:
a row computed twice is written twice, a column in no slice or in two is a
wrong sum, and there is no GPU here to catch either. So these tests hold,
for N across the tile edges, the plan's switches and up to 2^21, and for
three SM counts: every row is owned by exactly one (block, thread, k),
every column lies in exactly one slice and every slice is non-empty (the
launcher refuses other plans), and the plan's own grid holds at least two
waves of resident blocks wherever N allows that at all. The same holds for
the other plans ``ab_kernels.g_plans`` times beside it. The constants the
plan mirrors are read out of the kernel's source.
"""
import re
from pathlib import Path

import numpy as np
import pytest

from sphax_torch import ab_kernels
from sphax_torch.physics import direct_gravity as dg

SRC = (Path(dg.__file__).resolve().parent.parent / "csrc"
       / "gravity_kernel.cu").read_text()

NS = [1, 255, 256, 257, 4096, 10000, 16384, 20000, 23000, 65537, 64 ** 3,
      10 ** 6, 2 ** 21]
SMS = [132, 114, 1]


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


def test_plan_constants_match_the_kernel_source():
    assert dg.THREADS == _const("THREADS")
    assert dg.TILE == _const("TILE")
    assert dg.BLOCKS_PER_SM == _const("MIN_BLOCKS")
    assert dg.ROWS == _const("ROWS")
    assert "__launch_bounds__(THREADS, MIN_BLOCKS)" in SRC


def _covers_once(n, plan):
    rows, threads, slices, cols = plan
    assert rows == dg.ROWS and threads == dg.THREADS
    assert 1 <= slices <= 65535 and cols > 0 and cols % dg.TILE == 0

    per_block = threads * rows
    row_blocks = -(-n // per_block)
    b, t, k = np.meshgrid(np.arange(row_blocks), np.arange(threads),
                          np.arange(rows), indexing="ij")
    own = (b * per_block + t + k * threads).ravel()
    own = own[own < n]
    assert own.size == n
    np.testing.assert_array_equal(np.sort(own), np.arange(n))

    lo = np.arange(slices) * cols
    hi = np.minimum(lo + cols, n)
    assert bool((hi > lo).all()), "an empty slice"
    np.testing.assert_array_equal(
        np.concatenate([np.arange(a, z) for a, z in zip(lo, hi)]),
        np.arange(n))
    return row_blocks


@pytest.mark.parametrize("sm_count", SMS)
@pytest.mark.parametrize("n", NS)
def test_plan_covers_rows_and_columns_once(n, sm_count):
    plan = dg.gravity_plan(n, sm_count)
    row_blocks = _covers_once(n, plan)
    resident = sm_count * dg.BLOCKS_PER_SM
    # one tile a slice
    most = -(-n // (plan[1] * dg.ROWS)) * -(-n // dg.TILE)
    if most >= 2 * resident:
        assert row_blocks * plan[2] >= 2 * resident, plan


@pytest.mark.parametrize("n", NS)
def test_sweep_plans_cover_rows_and_columns_once(n):
    """``ab_kernels.g_plans``: one slice up to one tile a slice, which the
    launcher must take."""
    plans = ab_kernels.g_plans(n, 132)
    assert plans["plan"] == dg.gravity_plan(n, 132)
    for plan in plans.values():
        _covers_once(n, plan)


def test_plan_prefers_register_tiles_at_large_n():
    """Four rows a thread at N = 64^3 on 132 SMs, and the fewest slices
    that reach the plan's waves: one slice fewer falls short."""
    rows, _, slices, cols = dg.gravity_plan(64 ** 3, 132)
    assert rows == 4
    row_blocks = 64 ** 3 // (dg.THREADS * 4)
    target = dg.WAVES * 132 * dg.BLOCKS_PER_SM
    assert row_blocks * slices >= target
    assert row_blocks * (slices - 1) < target
