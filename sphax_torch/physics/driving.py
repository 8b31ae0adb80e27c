"""Stochastic large-scale turbulence driving (torch twin of
``sphax.physics.driving`` and ``sphax.run.DriveSpec``).

Ornstein-Uhlenbeck process on a few low-k Fourier modes with solenoidal
projection:

    A_k(t+dt) = A_k e^{-dt/tau} + sigma sqrt(1 - e^{-2 dt/tau}) xi_k

and a(x) = sum_k Re[A_k e^{i k.x}]. The standard-normal draws xi are an
argument of ``update``: the reference draws them from ``jax.random``, which
torch cannot reproduce, so a test feeds both packages the same draws and a
run draws them from a ``torch.Generator`` (``gaussian_noise``).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


class DriveSpec(NamedTuple):
    """Static description of turbulence driving."""

    modes: tuple          # tuple-of-tuples of ints
    tau: float
    accel_rms: float
    box_size: float = 1.0


class DriveState(NamedTuple):
    amp_re: torch.Tensor  # [n_modes, D] real part of mode amplitudes
    amp_im: torch.Tensor  # [n_modes, D] imag part


def make_modes(kmin: int = 1, kmax: int = 2, dtype=np.float64):
    """Integer wavevectors with kmin <= |k| <= kmax (host-side, static)."""
    rng = range(-kmax, kmax + 1)
    ks = [(i, j, k) for i in rng for j in rng for k in rng
          if kmin**2 <= i * i + j * j + k * k <= kmax**2]
    # keep one of each +/- pair (the field is real)
    seen, keep = set(), []
    for k in ks:
        if tuple(-x for x in k) not in seen:
            seen.add(k)
            keep.append(k)
    return np.asarray(keep, dtype)


def init(n_modes: int, dtype=torch.float64, device=None) -> DriveState:
    z = torch.zeros((n_modes, 3), dtype=dtype, device=device)
    return DriveState(amp_re=z, amp_im=z.clone())


class GaussianNoise:
    """Noise source for ``wengine.simulate`` and ``run.simulate``: two
    standard-normal draws of the amplitude shape per step, from
    ``generator`` (on the run's device)."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def __call__(self, shape, dtype, device):
        return tuple(torch.randn(shape, generator=self.generator,
                                 dtype=dtype, device=device)
                     for _ in range(2))

    def reseed(self, seed: int, step: int):
        """Restart the stream at a chunk boundary from (seed, step), so a
        run resumed at ``step`` draws what an uninterrupted run draws."""
        self.generator.manual_seed((int(seed) << 32) | int(step))


def gaussian_noise(generator: torch.Generator) -> GaussianNoise:
    return GaussianNoise(generator)


def _solenoidal_project(amp, khat):
    """Remove the component parallel to k: a -> a - (a.khat) khat."""
    return amp - torch.sum(amp * khat, dim=-1, keepdim=True) * khat


def update(drive: DriveState, modes, dt, tau: float, accel_rms: float,
           box_size: float = 1.0, *, noise) -> DriveState:
    """One OU step for the mode amplitudes; ``noise = (xi_re, xi_im)``,
    standard normals of the amplitude shape."""
    dtype = drive.amp_re.dtype
    k = modes.to(dtype) * (2.0 * math.pi / box_size)
    khat = k / torch.linalg.norm(k, dim=-1, keepdim=True)
    f = torch.exp(-dt / tau)
    sigma = accel_rms / math.sqrt(drive.amp_re.shape[0])
    noise_scale = sigma * torch.sqrt(1.0 - f * f)
    xi_re, xi_im = noise
    re = drive.amp_re * f + noise_scale * xi_re
    im = drive.amp_im * f + noise_scale * xi_im
    return DriveState(amp_re=_solenoidal_project(re, khat),
                      amp_im=_solenoidal_project(im, khat))


def acceleration(pos, drive: DriveState, modes, box_size: float = 1.0):
    """a(x_i) = sum_k [ Re(A_k) cos(k.x) - Im(A_k) sin(k.x) ] -> [N, 3].
    Needs full-precision fp32 matmuls on the card (TF32 off)."""
    k = modes.to(pos.dtype) * (2.0 * math.pi / box_size)
    phase = pos @ k.T                                   # [N, n_modes]
    return torch.cos(phase) @ drive.amp_re - torch.sin(phase) @ drive.amp_im
