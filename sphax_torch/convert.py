"""Carry state across from NumPy (and so from the JAX package's arrays).

The tests feed both packages the same arrays through these; a run can
resume from arrays the reference wrote. The slab and pencil
decompositions' specs and their sharded layout (the JAX package's
[n_shards * n_local] arrays, shard after shard), the cell list's grid and
the sorted mesh's plan carry across too.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from sphax_torch.core.state import Domain, ParticleState
from sphax_torch.dist.pencil import PencilSpec
from sphax_torch.dist.slab import DistSpec
from sphax_torch.dist.wslab import WSlabSpec
from sphax_torch.neighbors.cell_list import Grid
from sphax_torch.neighbors.window import WindowSpec
from sphax_torch.physics.driving import DriveState
from sphax_torch.physics.pm_sorted import MeshPlan


def state_from_numpy(arrays: Dict[str, np.ndarray], device,
                     dtype) -> ParticleState:
    """ParticleState from a dict holding all 13 fields."""
    return ParticleState(**{
        k: torch.as_tensor(np.array(arrays[k]), dtype=dtype, device=device)
        for k in ParticleState._fields})


def state_to_numpy(state: ParticleState) -> Dict[str, np.ndarray]:
    return {k: getattr(state, k).detach().cpu().numpy()
            for k in ParticleState._fields}


def domain_from_numpy(lo, hi, periodic, device, dtype=None) -> Domain:
    lo = torch.as_tensor(np.array(lo), dtype=dtype, device=device)
    hi = torch.as_tensor(np.array(hi), dtype=lo.dtype, device=device)
    periodic = periodic if isinstance(periodic, bool) else tuple(periodic)
    return Domain(lo=lo, hi=hi, periodic=periodic)


def spec_from_fields(**fields) -> WindowSpec:
    """WindowSpec from the fields of a reference spec
    (``spec_from_fields(**dataclasses.asdict(jax_spec))``)."""
    fields = dict(fields)
    fields["res"] = tuple(int(r) for r in fields["res"])
    fields["ghost_caps"] = tuple(int(c) for c in fields["ghost_caps"])
    return WindowSpec(**fields)


def grid_from_fields(**fields) -> Grid:
    """cell_list.Grid from the fields of a reference grid
    (``grid_from_fields(**dataclasses.asdict(jax_grid))``)."""
    return Grid(res=tuple(int(r) for r in fields["res"]),
                capacity=int(fields["capacity"]))


def mesh_plan_from_fields(**fields) -> MeshPlan:
    """pm_sorted.MeshPlan from the fields of a reference plan
    (``mesh_plan_from_fields(**dataclasses.asdict(jax_plan))``)."""
    return MeshPlan(**{k: int(v) for k, v in fields.items()})


def drive_from_numpy(amp_re, amp_im, device=None, dtype=None) -> DriveState:
    re = torch.as_tensor(np.array(amp_re), dtype=dtype, device=device)
    im = torch.as_tensor(np.array(amp_im), dtype=re.dtype, device=device)
    return DriveState(amp_re=re, amp_im=im)


def wslab_spec_from_fields(**fields) -> WSlabSpec:
    """WSlabSpec from the fields of a reference spec
    (``wslab_spec_from_fields(**dataclasses.asdict(jax_spec))``); the JAX
    package's mesh axis name has no counterpart and is dropped."""
    fields = dict(fields)
    fields.pop("axis_name", None)
    w = fields.pop("wspec")
    return WSlabSpec(wspec=w if isinstance(w, WindowSpec)
                     else spec_from_fields(**w),
                     **{k: int(v) for k, v in fields.items()})


def dist_spec_from_fields(**fields) -> DistSpec:
    """slab.DistSpec from the fields of a reference spec
    (``dist_spec_from_fields(**dataclasses.asdict(jax_spec))``); the JAX
    package's mesh axis name has no counterpart and is dropped."""
    fields = dict(fields)
    fields.pop("axis_name", None)
    g = fields.pop("grid")
    return DistSpec(grid=g if isinstance(g, Grid) else grid_from_fields(**g),
                    margin=float(fields.pop("margin")),
                    **{k: int(v) for k, v in fields.items()})


def pencil_spec_from_fields(**fields) -> PencilSpec:
    """PencilSpec from the fields of a reference spec
    (``pencil_spec_from_fields(**dataclasses.asdict(jax_spec))``)."""
    fields = dict(fields)
    w = fields.pop("wspec")
    return PencilSpec(wspec=w if isinstance(w, WindowSpec)
                      else spec_from_fields(**w),
                      **{k: int(v) for k, v in fields.items()})


def shard_from_numpy(rows: Dict[str, np.ndarray], spec,
                     rank: int, device, dtype) -> ParticleState:
    """Rank ``rank``'s [n_local] rows of a sharded layout (``spec`` a
    WSlabSpec or a PencilSpec): every field as
    [n_shards * n_local] rows, shard after shard (a sharded JAX state
    through ``state_to_numpy``-like conversion, or ``runner.lockstep``'s
    records)."""
    nl = spec.n_local
    return state_from_numpy(
        {k: np.asarray(rows[k])[rank * nl:(rank + 1) * nl]
         for k in ParticleState._fields}, device, dtype)
