"""Subsonic isothermal turbulence: the unit box at rho0 on a lattice with
the box's own fixed jitter, and a velocity field drawn from the seed that
stands in for the driven steady state.

The field is Gaussian and solenoidal, with the power spectrum
|v(k)|^2 ~ |k|^slope for 1 <= |k| <= n/2 in units of 2 pi / L (slope
-11/3: Kolmogorov's E(k) ~ k^-5/3), made on the lattice by one FFT and
scaled to the 3D rms ``vel_rms``. Each particle takes the value at its
lattice node.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.ics import lattice, on_device


def velocity_field(n: int, rms: float, slope: float, gen, dtype, device):
    """[n^3, 3] in the lattice's order."""
    k1 = torch.fft.fftfreq(n, d=1.0 / n, dtype=dtype, device=device)
    kz = torch.fft.rfftfreq(n, d=1.0 / n, dtype=dtype, device=device)
    k = torch.stack(torch.meshgrid(k1, k1, kz, indexing="ij"))
    k2 = (k * k).sum(0)
    band = (k2 >= 1.0) & (k2 <= (n / 2) ** 2)
    amp = torch.where(band, torch.clamp_min(k2, 1.0) ** (slope / 4.0), 0.0)
    vk = []
    for _ in range(3):
        w = torch.randn((n, n, n), generator=gen, dtype=dtype, device=device)
        vk.append(torch.fft.rfftn(w) * amp)
        del w
    vk = torch.stack(vk)
    # keep the part perpendicular to k
    kdotv = (k * vk).sum(0) / torch.clamp_min(k2, 1.0)
    vk = vk - k * kdotv
    del k, kdotv, amp
    v = torch.stack([torch.fft.irfftn(vk[c], s=(n, n, n)).reshape(-1)
                     for c in range(3)], dim=-1)
    del vk
    v = v - v.mean(0)
    return v * (rms / torch.sqrt((v * v).sum(-1).mean()))


def build(ic: dict, gen, dtype, device) -> dict:
    n = int(ic["n_side"])
    pos = lattice(n)
    rng = np.random.default_rng(int(ic["jitter_seed"]))
    pos = np.mod(pos + float(ic["jitter"]) / n
                 * rng.standard_normal(pos.shape), 1.0)
    count = len(pos)
    out = on_device(dict(pos=pos, mass=np.full(count, float(ic["rho0"])
                                               / count),
                         u=np.ones(count),
                         h=np.full(count, float(ic["eta"]) / n)),
                    dtype, device)
    out["vel"] = velocity_field(n, float(ic["vel_rms"]), float(ic["slope"]),
                                gen, dtype, device)
    return out
