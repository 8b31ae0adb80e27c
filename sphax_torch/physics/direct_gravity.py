"""Kernel G, the open-boundary direct-sum gravity: wrapper and plain version.

``gravity`` replaces the Pallas TPU kernel
``sphax.physics.pallas_kernels.gravity``: acc_i = -G sum_j m_j
(r_ij^2 + eps^2)^-3/2 dx_ij over all pairs, Plummer-softened, with no
periodic min-image. Self-pairs give exactly zero because dx = 0, which
needs ``grav_eps > 0``.

A CUDA tensor launches the hand-written kernel
(``sphax_torch/csrc/gravity_kernel.cu``) or raises; a CPU tensor runs the
plain torch version beside it, ``gravity_plain``, which is also what the
kernel is held against on the card. ``gravity_plan`` cuts the launch into
row blocks and column slices for a card's SM count.
"""
from __future__ import annotations

import functools

import torch

from sphax_torch.configs import SPHConfig
from sphax_torch.physics import window_kernels as wk


def _check_eps(cfg: SPHConfig):
    if float(cfg.grav_eps) <= 0.0:
        raise ValueError("cfg.grav_eps must be > 0 for the direct-sum "
                         "gravity kernel (softening also guards the "
                         "self-pair)")


def gravity_plain(pos, mass, cfg: SPHConfig, rows=None):
    """Row-blocked torch direct sum, the same math as the kernel. With
    ``rows`` (an index tensor) only those rows are computed, against all N
    columns: a sample of a large N at a fraction of the cost."""
    _check_eps(cfg)
    from sphax_torch.physics.clist import _blocked

    n = pos.shape[0]
    eps2 = float(cfg.grav_eps) ** 2

    def body(pos_i):
        dx = pos_i[:, None, :] - pos[None, :, :]
        r2 = torch.sum(dx * dx, -1) + eps2
        inv = mass[None, :] * torch.rsqrt(r2) / r2
        return -float(cfg.G) * torch.sum(inv[..., None] * dx, dim=-2)

    # keep each block's [B, N, 3] intermediates near 2^24 elements
    return _blocked(body, pos if rows is None else pos[rows],
                    max(1, min(n, (1 << 24) // max(n, 1))))


# csrc/gravity_kernel.cu: threads a block, columns a staged tile, the
# blocks a SM that its __launch_bounds__ keep room for, and the rows a
# thread it is instantiated for
THREADS = 128
TILE = 256
BLOCKS_PER_SM = 4
ROWS = 4
# resident blocks' worth of grid the plan asks for where N allows
WAVES = 8


def _cdiv(a, b):
    return -(-a // b)


def gravity_plan(n: int, sm_count: int):
    """(rows_per_thread, threads, slices, cols_per_slice) of a kernel G
    launch on N particles. The grid is (row blocks of threads *
    rows_per_thread rows) x (slices of cols_per_slice columns, whole tiles,
    the last one ragged). It takes the fewest slices that let the grid
    hold ``WAVES`` times the blocks the card keeps resident, as even as
    whole tiles allow; where N is too small for that, one tile a slice."""
    target = WAVES * sm_count * BLOCKS_PER_SM
    n_tiles = max(1, _cdiv(n, TILE))
    row_blocks = max(1, _cdiv(n, THREADS * ROWS))
    # tiles a slice
    per = max(1, _cdiv(n_tiles, max(1, _cdiv(target, row_blocks))))
    while per > 1 and row_blocks * _cdiv(n_tiles, per) < target:
        per -= 1
    return ROWS, THREADS, _cdiv(n_tiles, per), per * TILE


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def gravity(pos, mass, cfg: SPHConfig):
    """Kernel G. pos [N, 3], mass [N] -> acc [N, 3]."""
    _check_eps(cfg)
    if pos.device.type == "cpu":
        return gravity_plain(pos, mass, cfg)
    if pos.device.type != "cuda":
        raise ValueError(f"no kernel for device {pos.device}")
    n, dim = pos.shape
    if dim != 3:
        raise NotImplementedError("the CUDA gravity kernel is built for "
                                  "dim=3 only")
    if pos.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"unsupported dtype {pos.dtype}")
    if (mass.device != pos.device or mass.dtype != pos.dtype
            or tuple(mass.shape) != (n,)):
        raise ValueError(f"mass must be a [{n}] {pos.dtype} tensor on "
                         f"{pos.device}")
    if n == 0:
        return torch.empty((0, 3), dtype=pos.dtype, device=pos.device)
    return _launch(pos, mass, cfg, gravity_plan(n, _sm_count(pos.device)))


def _launch(pos, mass, cfg: SPHConfig, plan):
    """One launch of kernel G on checked CUDA inputs with a given plan
    (``gravity_plan``'s tuple)."""
    n = pos.shape[0]
    rows, threads, slices, cols = plan
    if threads != THREADS:
        raise ValueError(f"kernel G is built for {THREADS} threads a block, "
                         f"not {threads}")
    acc = torch.empty((n, 3), dtype=pos.dtype, device=pos.device)
    # [N, 4] records x, y, z, m: one 16-byte (fp32) load a column
    src = torch.cat([pos, mass[:, None]], 1)
    work = (torch.empty((slices, 3, n), dtype=pos.dtype, device=pos.device)
            if slices > 1 else None)
    wk._launch("gravity", pos.dtype, wk._ptr(src), n,
               float(cfg.grav_eps) ** 2, float(cfg.G), rows, slices, cols,
               None if work is None else wk._ptr(work), wk._ptr(acc))
    return acc
