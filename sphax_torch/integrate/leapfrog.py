"""Leapfrog kick-drift-kick integrator (torch twin of
``sphax.integrate.leapfrog``; the same frozen step sequence):

  1. dt from current derived state (unless supplied)
  2. half-kick  v += a dt/2 ; u += du dt/2 (floored)
  3. drift      x += v dt (periodic wrap unless ``wrap=False``)
  4. recompute derived quantities (``derived_fn``)
  5. half-kick with the new derivatives
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from sphax_torch.configs import SPHConfig
from sphax_torch.core.state import Domain, ParticleState
from sphax_torch.integrate.timestep import local_dt
from sphax_torch.physics import pairs

DerivedFn = Callable[[ParticleState], ParticleState]


def step(state: ParticleState, cfg: SPHConfig, domain: Domain,
         derived_fn: DerivedFn, dt=None,
         wrap: bool = True) -> Tuple[ParticleState, torch.Tensor]:
    """One KDK step. ``wrap=False`` leaves drifted positions unwrapped (the
    window engine wraps only at rebuilds)."""
    if dt is None:
        dt = local_dt(state, cfg)
    half = 0.5 * dt
    vel = state.vel + half * state.acc
    u = torch.clamp_min(state.u + half * state.du_dt, cfg.u_floor)
    pos = state.pos + dt * vel
    if wrap:
        pos = domain.wrap(pos)
    state = state._replace(pos=pos, vel=vel, u=u)
    if cfg.h_predict and cfg.adaptive_h:
        # continuity predictor dh/dt = (h/dim) div v through this drift; the
        # clamp bounds a pathological local divv to a 10% change
        fac = torch.clamp(1.0 + (dt / cfg.dim) * state.divv, 0.9, 1.1)
        state = state._replace(h=state.h * fac)
    state = derived_fn(state)
    vel = state.vel + half * state.acc
    u = torch.clamp_min(state.u + half * state.du_dt, cfg.u_floor)
    state = state._replace(vel=vel, u=u)
    if cfg.mm_visc:
        # Morris-Monaghan alpha(t): explicit Euler from the fresh div v
        state = state._replace(alpha=pairs.mm_alpha_update(
            state.alpha, state.divv, state.h, state.cs, dt, cfg))
    return state, dt
