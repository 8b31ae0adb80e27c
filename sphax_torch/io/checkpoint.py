"""Checkpoint / resume (torch twin of ``sphax.io.checkpoint``).

The full simulation state (every ParticleState field, the optional driving
amplitudes, the step counter and the time) is written as one compressed npz
with the JAX version's schema v2, key names and atomic write, so files move
between the two packages in both directions.

Driving: ``drive/key`` holds a uint32[2]. The JAX package stores its
threefry PRNG key there; the port's driving has no JAX key, so it writes
(seed, step) there, which loads in ``sphax`` as a valid key. After a resume
each package continues its own noise stream: ``sphax`` from the key in the
file, the port from (seed, step) (``python -m sphax_torch`` reseeds its
generator from the run's seed and the step at every chunk, so a resumed run
draws what the uninterrupted run would have drawn).
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Optional, Tuple

import numpy as np
import torch

from sphax_torch.core.state import ParticleState
from sphax_torch.physics.driving import DriveState

SCHEMA = 2  # v2: + ParticleState.divv (Morris-Monaghan source term)


def save(path: str, state: ParticleState, t: float, step: int,
         drive: Optional[DriveState] = None, extra: Optional[dict] = None,
         seed: int = 0):
    """Atomically write a checkpoint (temporary file + rename)."""
    payload = {f"state/{k}": getattr(state, k).detach().cpu().numpy()
               for k in state._fields}
    if drive is not None:
        payload["drive/amp_re"] = drive.amp_re.detach().cpu().numpy()
        payload["drive/amp_im"] = drive.amp_im.detach().cpu().numpy()
        payload["drive/key"] = np.array([seed, step], np.uint32)
    meta = dict(schema=SCHEMA, t=float(t), step=int(step),
                has_drive=drive is not None, extra=extra or {})
    payload["meta"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez_compressed(f, **payload)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load(path: str, device=None, dtype=None
         ) -> Tuple[ParticleState, float, int, Optional[DriveState], dict]:
    """Load a checkpoint -> (state, t, step, drive, extra), with the tensors
    on ``device`` (default: CUDA) in ``dtype`` (default: the file's).
    Older schemas migrate forward as in the JAX version: fields added since
    (alpha, divv) take their make_state values."""
    device = torch.device("cuda" if device is None else device)

    def tensor(a):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"]).decode())
        if meta["schema"] > SCHEMA:
            raise ValueError(
                f"checkpoint schema {meta['schema']} is newer than this "
                f"build's {SCHEMA}; upgrade the framework to resume it")
        n = z["state/pos"].shape[0]
        fdtype = z["state/pos"].dtype
        defaults = {"alpha": np.ones((n,), fdtype),
                    "divv": np.zeros((n,), fdtype)}
        fields = {}
        for k in ParticleState._fields:
            key = f"state/{k}"
            if key in z:
                fields[k] = tensor(z[key])
            elif k in defaults:
                fields[k] = tensor(defaults[k])
            else:
                raise ValueError(f"checkpoint missing required field {k}")
        state = ParticleState(**fields)
        drive = None
        if meta["has_drive"]:
            drive = DriveState(amp_re=tensor(z["drive/amp_re"]),
                               amp_im=tensor(z["drive/amp_im"]))
    return state, meta["t"], meta["step"], drive, meta.get("extra", {})


def verify_integrity(state: ParticleState) -> Optional[str]:
    """NaN/shape guard: returns a reason string if the state is corrupt,
    else None."""
    for k in state._fields:
        if not bool(torch.isfinite(getattr(state, k)).all()):
            return f"non-finite values in {k}"
    if bool((state.h <= 0).any()):
        return "non-positive smoothing length"
    if bool((state.mass < 0).any()):
        return "negative mass"
    return None
