"""Carry state across from NumPy (and so from the JAX package's arrays).

The tests feed both packages the same arrays through these; a run can
resume from arrays the reference wrote.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from sphax_torch.core.state import Domain, ParticleState
from sphax_torch.neighbors.window import WindowSpec
from sphax_torch.physics.driving import DriveState


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


def drive_from_numpy(amp_re, amp_im, device=None, dtype=None) -> DriveState:
    re = torch.as_tensor(np.array(amp_re), dtype=dtype, device=device)
    im = torch.as_tensor(np.array(amp_im), dtype=re.dtype, device=device)
    return DriveState(amp_re=re, amp_im=im)
