"""A periodic self-gravitating isothermal cloud from Gaussian density
fluctuations (Klessen, Burkert & Bate 1998; Klessen 2001).

The unit box at rho0 holds ``jeans`` Jeans masses: with M = rho0 L^3,
M_J = rho0 lambda_J^3 and lambda_J = (pi c_s^2 / (G rho0))^(1/2), that sets
G = pi c_s^2 jeans^(2/3) / (rho0 L^2) (``jeans_G``). The particles start
on the cell-centred n^3 lattice (x the slowest axis), displaced by the
Zel'dovich displacement psi of a Gaussian density field delta = -div psi:
P(k) ~ k^-2 for 1 <= |k| <= kmax box modes (modes with a component at the
lattice's Nyquist frequency left out, so that psi's gradient is exact),
drawn on the lattice's own FFT grid and scaled to ``delta_rms``. They start
at rest, with h = eta (m / (rho0 (1 + delta)))^(1/3) at each particle's
lattice node and u = 1 (the isothermal EOS does not read it).

The field is computed in float64 on ``device`` from a ``torch.Generator``
(one standard normal per lattice node), so a generator seeded alike gives
the same bits on the same device.
"""
from __future__ import annotations

import math

import torch


def jeans_G(jeans: float, cs: float = 1.0, rho0: float = 1.0,
            box: float = 1.0) -> float:
    """G at which the box of side ``box`` at ``rho0`` holds ``jeans``
    Jeans masses of an isothermal gas with sound speed ``cs``."""
    return math.pi * cs * cs * float(jeans) ** (2.0 / 3.0) / (rho0 * box
                                                              * box)


def free_fall_time(G: float, rho0: float = 1.0) -> float:
    """t_ff = (3 pi / (32 G rho0))^(1/2)."""
    return math.sqrt(3.0 * math.pi / (32.0 * G * rho0))


def gaussian_field(n: int, kmax: float, delta_rms: float, gen, device):
    """(delta [n^3], psi [n^3, 3]) on the n^3 lattice, float64, in its
    order: the density contrast and the displacement with delta =
    -div psi, P(k) ~ k^-2 for 1 <= |k| <= kmax, rms of delta
    ``delta_rms``."""
    f64 = torch.float64
    k1 = torch.fft.fftfreq(n, d=1.0 / n, dtype=f64, device=device)
    kz = torch.fft.rfftfreq(n, d=1.0 / n, dtype=f64, device=device)
    ks = (k1[:, None, None], k1[None, :, None], kz[None, None, :])
    k2 = ks[0] * ks[0] + ks[1] * ks[1] + ks[2] * ks[2]
    band = (k2 >= 1.0) & (k2 <= float(kmax) ** 2)
    for k in ks:
        band = band & (torch.abs(k) < 0.5 * n)
    k2 = torch.clamp_min(k2, 1.0)
    w = torch.randn((n, n, n), generator=gen, dtype=f64, device=device)
    dk = torch.fft.rfftn(w) * torch.where(band, torch.rsqrt(k2), 0.0)
    del w
    delta = torch.fft.irfftn(dk, s=(n, n, n))
    scale = float(delta_rms) / torch.sqrt(torch.mean(delta * delta))
    delta = (delta * scale).reshape(-1)
    # psi(k) = i k delta(k) / (2 pi |k|^2): then div psi = -delta
    dk = dk * (scale / (2.0 * math.pi) / k2)
    psi = torch.stack([torch.fft.irfftn(1j * k * dk, s=(n, n, n)).reshape(-1)
                       for k in ks], dim=-1)
    return delta, psi


def build(n_side: int = 64, jeans: float = 222.0, kmax: float = 16.0,
          delta_rms: float = 0.1, seed: int = 1, eta: float = 1.3,
          rho0: float = 1.0, gen=None, device="cpu"):
    """Return dict(pos, vel, mass, u, h, box, G) as float64 tensors on
    ``device`` (``box`` and ``G`` as floats). ``gen``, a torch.Generator on
    ``device``, draws the field; without it one is seeded with ``seed``."""
    n = int(n_side)
    if gen is None:
        gen = torch.Generator(device=device).manual_seed(int(seed))
    delta, psi = gaussian_field(n, kmax, delta_rms, gen, device)
    ax = (torch.arange(n, dtype=torch.float64, device=device) + 0.5) / n
    q = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"), dim=-1)
    pos = torch.remainder(q.reshape(-1, 3) + psi, 1.0)
    count = n ** 3
    mass = torch.full((count,), rho0 / count, dtype=torch.float64,
                      device=device)
    h = eta * (mass / (rho0 * (1.0 + delta))) ** (1.0 / 3.0)
    return dict(pos=pos, vel=torch.zeros_like(pos), mass=mass,
                u=torch.ones_like(mass), h=h, box=[1.0, 1.0, 1.0],
                G=jeans_G(jeans, rho0=rho0))
