"""Uniform-grid cell list with Morton-sorted particles (torch twin of
``sphax.neighbors.cell_list``).

  1. per-particle cell coords -> row-major cell id (any per-axis
     resolution) and a Morton key (the locality sort key);
  2. one stable sort by Morton key: same-cell particles become contiguous;
  3. a dense ``[ncells, capacity]`` index table built by one scatter
     (sentinel N in empty slots), giving any cell's particles at fixed
     shape;
  4. the engine (``sphax_torch.physics.clist``) then evaluates cell blocks
     against their stacked neighbour cells.

The sort is stable, as ``jnp.argsort`` is, so ``perm``, ``slot`` and
``table`` equal the JAX version's at ties. Indices are int64 (the JAX
version's int32), as torch indexing wants.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

from sphax_torch.core.state import Domain
from sphax_torch.neighbors import morton


@dataclasses.dataclass(frozen=True)
class Grid:
    """Cell-grid spec: per-axis resolution and per-cell capacity."""

    res: Tuple[int, ...]
    capacity: int

    @property
    def ncells(self) -> int:
        return int(np.prod(self.res))

    @property
    def dim(self) -> int:
        return len(self.res)

    def offsets(self) -> np.ndarray:
        """Neighbour-cell offsets, deduplicated for tiny resolutions:
        {-1, 0, 1} where res_d >= 3; {-1, 0} where res_d == 2 (-1 and +1
        alias under the periodic wrap); {0} where res_d == 1."""
        per_axis = []
        for r in self.res:
            if r >= 3:
                per_axis.append([-1, 0, 1])
            elif r == 2:
                per_axis.append([-1, 0])
            else:
                per_axis.append([0])
        grids = np.meshgrid(*per_axis, indexing="ij")
        return np.stack([g.ravel() for g in grids], axis=-1)  # [n_off, D]

    @property
    def n_candidates(self) -> int:
        return len(self.offsets()) * self.capacity


def choose_grid(domain: Domain, h_max: float, n: int, margin: float = 1.1,
                occupancy_safety: float = 3.0,
                max_cells: int = 2**22) -> Grid:
    """Host-side grid selection: cell size >= margin * support * h_max;
    capacity = safety * average occupancy, rounded up to a multiple of 4."""
    ext = domain.extent.detach().cpu().double().numpy()
    cut = 2.0 * float(h_max) * margin
    res = np.maximum(1, np.floor(ext / cut).astype(int))
    while int(np.prod(res)) > max_cells:
        res = np.maximum(1, res // 2)
    ncells = int(np.prod(res))
    avg = n / ncells
    cap = int(max(4, np.ceil(avg * occupancy_safety / 4) * 4))
    return Grid(res=tuple(int(r) for r in res), capacity=cap)


class CellList(NamedTuple):
    """Built cell structure over a *sorted* particle set.

    perm:      [N]  original index of the k-th sorted particle
    cid:       [N]  row-major cell id per sorted particle
    slot:      [N]  slot of each sorted particle within its cell (may be
                    >= capacity for overflowing particles, which the table
                    drops; ``overflow`` counts them)
    table:     [ncells, capacity] sorted-particle index per slot, sentinel N
    overflow:  []   number of particles that did not fit their cell
    """

    perm: torch.Tensor
    cid: torch.Tensor
    slot: torch.Tensor
    table: torch.Tensor
    overflow: torch.Tensor


def _strides(grid: Grid, device) -> torch.Tensor:
    strides = np.concatenate([np.cumprod(grid.res[::-1])[-2::-1], [1]])
    return torch.as_tensor(strides.astype(np.int64), device=device)


def cell_coords(pos, domain: Domain, grid: Grid):
    """Integer cell coords [N, D] (int64) for positions, clipped into the
    grid."""
    res = torch.as_tensor(grid.res, dtype=pos.dtype, device=pos.device)
    x = (pos - domain.lo) / domain.extent * res
    c = torch.minimum(torch.clamp_min(torch.floor(x), 0), res - 1)
    return c.to(torch.int64)


def row_major_cid(coords, grid: Grid):
    return torch.sum(coords * _strides(grid, coords.device), dim=-1)


def build(pos, domain: Domain, grid: Grid) -> CellList:
    """Build the cell list: one stable sort and one scatter, on the
    positions' device."""
    n = pos.shape[0]
    dev = pos.device
    coords = cell_coords(pos, domain, grid)
    cid = row_major_cid(coords, grid)
    key = morton.encode(coords)
    key_s, perm = torch.sort(key, stable=True)
    cid_s = cid[perm]

    idx = torch.arange(n, dtype=torch.int64, device=dev)
    is_new = torch.ones(n, dtype=torch.bool, device=dev)
    is_new[1:] = key_s[1:] != key_s[:-1]
    seg_start = torch.cummax(torch.where(is_new, idx, 0), dim=0).values
    slot = idx - seg_start

    cap = grid.capacity
    valid = slot < cap
    overflow = torch.sum(~valid)
    # overflowing rows go to one trash slot past the table, then dropped
    # (the JAX version's mode="drop" scatter)
    flat = torch.full((grid.ncells * cap + 1,), n, dtype=torch.int64,
                      device=dev)
    flat[torch.where(valid, cid_s * cap + slot, grid.ncells * cap)] = idx
    table = flat[:-1].reshape(grid.ncells, cap)
    return CellList(perm=perm, cid=cid_s, slot=slot, table=table,
                    overflow=overflow)


def neighbor_cids(cids, grid: Grid, periodic):
    """Row-major ids of the neighbour cells of each cell in ``cids``.

    Returns ([B, n_off] cell ids, [B, n_off] validity mask). ``periodic`` is
    a bool or a per-axis tuple: periodic axes wrap, open axes mask the
    out-of-range neighbour cells."""
    dim = grid.dim
    dev = cids.device
    per = (periodic,) * dim if isinstance(periodic, bool) else tuple(periodic)
    res = torch.as_tensor(grid.res, dtype=torch.int64, device=dev)
    strides = _strides(grid, dev)
    coords = torch.remainder(torch.div(cids[:, None], strides[None, :],
                                       rounding_mode="floor"),
                             res[None, :])                        # [B, D]
    offs = torch.as_tensor(grid.offsets().astype(np.int64), device=dev)
    nc = coords[:, None, :] + offs[None, :, :]              # [B, n_off, D]
    wrapped = torch.remainder(nc, res)
    in_range = (nc >= 0) & (nc < res)
    per_mask = torch.as_tensor(per, device=dev)                   # [D]
    nc = torch.where(per_mask, wrapped,
                     torch.minimum(torch.clamp_min(nc, 0), res - 1))
    ok = torch.all(per_mask | in_range, dim=-1)
    return torch.sum(nc * strides, dim=-1), ok
