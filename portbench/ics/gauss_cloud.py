"""A periodic cloud from Gaussian density fluctuations (Klessen, Burkert &
Bate 1998): the cell-centred n^3 lattice of the unit box at rho0,
displaced by the Zel'dovich displacement psi of a Gaussian field delta =
-div psi with P(k) ~ k^-2 for 1 <= |k| <= kmax box modes (no mode with a
component at the lattice's Nyquist frequency), its rms scaled to
``delta_rms``; at rest, h = eta (m / (rho0 (1 + delta)))^(1/3) at each
particle's lattice node, u = 1.

The field is drawn from ``gen`` (one standard normal a lattice node, in
float64 on ``device``) and computed in float64; the state is then cast to
``dtype``. The program's own set-up (``sphax_torch.ics.cloud``) gives the
same numbers from a generator seeded alike.
"""
from __future__ import annotations

import math

import torch


def field(n: int, kmax: float, delta_rms: float, gen, device):
    """(delta [n^3], psi [n^3, 3]) in the lattice's order, x slowest."""
    f64 = torch.float64
    kf = torch.fft.fftfreq(n, d=1.0 / n, dtype=f64, device=device)
    kr = torch.fft.rfftfreq(n, d=1.0 / n, dtype=f64, device=device)
    ks = (kf[:, None, None], kf[None, :, None], kr[None, None, :])
    k2 = ks[0] * ks[0] + ks[1] * ks[1] + ks[2] * ks[2]
    keep = (k2 >= 1.0) & (k2 <= float(kmax) ** 2)
    for k in ks:
        keep = keep & (torch.abs(k) < 0.5 * n)
    k2 = torch.clamp_min(k2, 1.0)
    noise = torch.randn((n, n, n), generator=gen, dtype=f64, device=device)
    dk = torch.fft.rfftn(noise) * torch.where(keep, torch.rsqrt(k2), 0.0)
    del noise
    delta = torch.fft.irfftn(dk, s=(n, n, n))
    scale = float(delta_rms) / torch.sqrt(torch.mean(delta * delta))
    delta = (delta * scale).reshape(-1)
    dk = dk * (scale / (2.0 * math.pi) / k2)
    psi = torch.stack([torch.fft.irfftn(1j * k * dk, s=(n, n, n)).reshape(-1)
                       for k in ks], dim=-1)
    return delta, psi


def build(ic: dict, gen, dtype, device) -> dict:
    n = int(ic["n_side"])
    rho0, eta = float(ic["rho0"]), float(ic["eta"])
    delta, psi = field(n, float(ic["kmax"]), float(ic["delta_rms"]), gen,
                       device)
    ax = (torch.arange(n, dtype=torch.float64, device=device) + 0.5) / n
    q = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"), dim=-1)
    pos = torch.remainder(q.reshape(-1, 3) + psi, 1.0)
    count = n ** 3
    mass = torch.full((count,), rho0 / count, dtype=torch.float64,
                      device=device)
    h = eta * (mass / (rho0 * (1.0 + delta))) ** (1.0 / 3.0)
    out = dict(pos=pos, vel=torch.zeros_like(pos), mass=mass,
               u=torch.ones_like(mass), h=h)
    return {k: v.to(dtype) for k, v in out.items()}
