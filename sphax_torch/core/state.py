"""Particle state and simulation domain (torch twin of ``sphax.core.state``).

``ParticleState`` is a structure of arrays: every field is a flat ``[N]`` or
``[N, D]`` tensor on one device, updated functionally with ``_replace``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

Tensor = torch.Tensor


class ParticleState(NamedTuple):
    """SoA particle state; all tensors share leading dim N.

    ``rho``/``P``/``cs``/``acc``/``du_dt``/``omega``/``divv`` are derived
    quantities cached from the latest density/force evaluation so a KDK
    step can open with a half-kick without recomputing them.
    """

    pos: Tensor    # [N, D] positions
    vel: Tensor    # [N, D] velocities
    mass: Tensor   # [N]    particle masses
    u: Tensor      # [N]    specific internal energy
    h: Tensor      # [N]    smoothing lengths
    rho: Tensor    # [N]    mass density (derived)
    P: Tensor      # [N]    pressure (derived)
    cs: Tensor     # [N]    sound speed (derived)
    acc: Tensor    # [N, D] acceleration (derived)
    du_dt: Tensor  # [N]    du/dt (derived)
    omega: Tensor  # [N]    grad-h correction factor (derived; 1 if off)
    alpha: Tensor  # [N]    per-particle viscosity alpha(t)
    divv: Tensor   # [N]    SPH velocity-divergence estimate (derived)

    @property
    def n(self) -> int:
        return self.pos.shape[0]

    @property
    def dim(self) -> int:
        return self.pos.shape[1]


def make_state(pos, vel, mass, u, h, alpha0: float = 1.0) -> ParticleState:
    """ParticleState with derived fields zero-initialised, on ``pos``'s
    device and dtype (the other fields are converted to match)."""
    pos = torch.as_tensor(pos)
    n, d = pos.shape
    kw = dict(dtype=pos.dtype, device=pos.device)
    z = torch.zeros((n,), **kw)
    return ParticleState(
        pos=pos,
        vel=torch.as_tensor(vel, **kw),
        mass=torch.as_tensor(mass, **kw),
        u=torch.as_tensor(u, **kw),
        h=torch.as_tensor(h, **kw),
        rho=z,
        P=z,
        cs=z,
        acc=torch.zeros((n, d), **kw),
        du_dt=z,
        omega=torch.ones((n,), **kw),
        alpha=torch.full((n,), alpha0, **kw),
        divv=z,
    )


@dataclasses.dataclass(frozen=True)
class Domain:
    """Rectangular simulation box. ``periodic`` is a bool or a per-axis
    tuple of bools."""

    lo: Tensor  # [D]
    hi: Tensor  # [D]
    periodic: object = True

    @property
    def extent(self) -> Tensor:
        return self.hi - self.lo

    def periodic_axes(self, dim: int) -> Tuple[bool, ...]:
        p = self.periodic
        if isinstance(p, bool):
            return (p,) * dim
        return tuple(p)

    def wrap(self, pos: Tensor) -> Tensor:
        """Map positions back into the box on periodic axes."""
        per = self.periodic_axes(pos.shape[-1])
        if not any(per):
            return pos
        wrapped = self.lo + torch.remainder(pos - self.lo, self.extent)
        if all(per):
            return wrapped
        mask = torch.tensor(per, device=pos.device)
        return torch.where(mask, wrapped, pos)

    def displacement(self, dx: Tensor) -> Tensor:
        """Minimum-image convention displacement for raw dx = x_i - x_j."""
        per = self.periodic_axes(dx.shape[-1])
        if not any(per):
            return dx
        ext = self.extent
        mi = dx - ext * torch.round(dx / ext)
        if all(per):
            return mi
        mask = torch.tensor(per, device=dx.device)
        return torch.where(mask, mi, dx)


def box(lo, hi, periodic: bool = True, dtype=None, device=None) -> Domain:
    lo = torch.as_tensor(lo, dtype=dtype, device=device)
    hi = torch.as_tensor(hi, dtype=lo.dtype, device=lo.device)
    return Domain(lo=lo, hi=hi, periodic=periodic)
