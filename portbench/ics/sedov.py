"""The Sedov-Taylor point blast: the unit box at rho0 and u_bg with energy
E deposited kernel-weighted within ``r_inj_cells`` lattice spacings of the
centre (sum m du = E), at rest; ``jitter_max`` moves each position by up to
that many lattice spacings per axis, drawn from the seed."""
from __future__ import annotations

import numpy as np
import torch

from portbench.ics import lattice, on_device


def _cubic_f(q):
    return np.where(q < 1.0, 1.0 - 1.5 * q**2 + 0.75 * q**3,
                    np.where(q < 2.0, 0.25 * (2.0 - q) ** 3, 0.0))


def build(ic: dict, gen, dtype, device) -> dict:
    n = int(ic["n_side"])
    pos = lattice(n)
    count = len(pos)
    d = 1.0 / n
    mass = np.full(count, float(ic["rho0"]) / count)
    r = np.sqrt(np.sum((pos - 0.5) ** 2, axis=-1))
    w = _cubic_f(2.0 * r / (float(ic["r_inj_cells"]) * d))
    u = float(ic["u_bg"]) + float(ic["E"]) * w / np.sum(w * mass)
    out = on_device(dict(pos=pos, mass=mass, u=u,
                         h=np.full(count, float(ic["eta"]) * d)),
                    dtype, device)
    shape = out["pos"].shape
    out["vel"] = torch.zeros(shape, dtype=dtype, device=device)
    amp = float(ic["jitter_max"]) * d
    step = (2.0 * torch.rand(shape, generator=gen, dtype=dtype,
                             device=device) - 1.0) * amp
    out["pos"] = torch.remainder(out["pos"] + step, 1.0)
    return out
