"""Run loop (torch twin of ``sphax.run``): chunks of KDK steps with any
engine, the host synchronising only between chunks.

The JAX version compiles a chunk into one ``lax.scan``; here a chunk is a
Python loop over ``leapfrog.step`` that queues work on the device and reads
nothing back, so the host waits once per chunk (``simulate_until`` sums the
chunk's dts).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from sphax_torch.configs import SPHConfig
from sphax_torch.core.state import Domain, ParticleState
from sphax_torch.integrate import leapfrog
from sphax_torch.integrate.timestep import local_dt
from sphax_torch.physics import driving as drv
from sphax_torch.physics.driving import DriveSpec  # noqa: F401 (re-export)


def simulate(state: ParticleState, cfg: SPHConfig, domain: Domain,
             engine_fn: Callable, nsteps: int, drive=None,
             drive_spec: Optional[DriveSpec] = None, noise=None):
    """Advance ``nsteps`` KDK steps. Returns (state, drive, dts [nsteps]).

    engine_fn: state -> state with fresh derived fields, e.g.
    ``lambda s: dense.update_derived(s, cfg, dom)``. With ``drive_spec`` the
    driving acceleration is added to every derived evaluation and the OU
    amplitudes advance once per step with the step's dt, from the
    standard-normal draws of ``noise(shape, dtype, device)``.
    """
    if drive_spec is not None and (drive is None or noise is None):
        raise ValueError("driving needs an initial DriveState and a noise "
                         "source")
    modes = None
    if drive_spec is not None:
        modes = torch.tensor(drive_spec.modes, dtype=state.pos.dtype,
                             device=state.pos.device)
    dts = []
    for _ in range(nsteps):
        dt = local_dt(state, cfg)
        if drive_spec is not None:
            xi = noise(drive.amp_re.shape, drive.amp_re.dtype,
                       drive.amp_re.device)
            drive = drv.update(drive, modes, dt, drive_spec.tau,
                               drive_spec.accel_rms, drive_spec.box_size,
                               noise=xi)

            def derived(s, dr=drive):
                out = engine_fn(s)
                a = drv.acceleration(s.pos, dr, modes, drive_spec.box_size)
                return out._replace(acc=out.acc + a)
        else:
            derived = engine_fn
        state, dt = leapfrog.step(state, cfg, domain, derived, dt=dt)
        dts.append(dt)
    return state, drive, torch.stack(dts)


def simulate_until(state, cfg, domain, engine_fn, t_end, chunk: int = 16,
                   drive=None, drive_spec=None, max_steps: int = 100_000,
                   callback=None, noise=None):
    """Run whole chunks of steps until t >= t_end or max_steps (checked
    between chunks, as in the JAX version). Returns (state, drive, t,
    nsteps); ``callback(state, t, nsteps)`` runs after every chunk."""
    t, n = 0.0, 0
    while t < t_end and n < max_steps:
        state, drive, dts = simulate(state, cfg, domain, engine_fn, chunk,
                                     drive, drive_spec, noise=noise)
        t += float(torch.sum(dts))
        n += chunk
        if callback is not None:
            callback(state, t, n)
    return state, drive, t, n
