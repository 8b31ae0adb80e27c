"""SPH smoothing kernels (cubic spline / M4), torch twin of
``sphax.physics.kernels`` — the same frozen convention:

    q = r / h,   support radius = 2 h
    W(r, h)  = sigma_d / h^d * f(q)
    f(q)     = 1 - 1.5 q^2 + 0.75 q^3          0 <= q < 1
             = 0.25 (2 - q)^3                  1 <= q < 2
             = 0                               q >= 2
    sigma_1 = 2/3,   sigma_2 = 10/(7 pi),   sigma_3 = 1/pi
    dW/dh = -(1/h) * (d * W + q * dW/dq)
"""
from __future__ import annotations

import math

import torch

_SIGMA = {1: 2.0 / 3.0, 2: 10.0 / (7.0 * math.pi), 3: 1.0 / math.pi}


def sigma(dim: int) -> float:
    """Cubic-spline normalisation constant for dimension ``dim``."""
    return _SIGMA[dim]


def _f(q):
    q1 = 1.0 - 1.5 * q * q + 0.75 * q * q * q
    t = 2.0 - q
    q2 = 0.25 * t * t * t
    w = torch.where(q < 1.0, q1, q2)
    return torch.where(q < 2.0, w, torch.zeros_like(q))


def _df(q):
    d1 = (-3.0 + 2.25 * q) * q
    t = 2.0 - q
    d2 = -0.75 * t * t
    d = torch.where(q < 1.0, d1, d2)
    return torch.where(q < 2.0, d, torch.zeros_like(q))


def W(r, h, dim: int):
    """Kernel value W(r, h)."""
    q = r / h
    return (sigma(dim) / h**dim) * _f(q)


def dW_dq(r, h, dim: int):
    """dW/dq = sigma/h^d f'(q)."""
    q = r / h
    return (sigma(dim) / h**dim) * _df(q)


def grad_W_over_r(r, h, dim: int, eps: float = 1e-30):
    """g(r, h) with grad_i W(r_ij, h) = g * r_ij; exact at r = 0 (the q < 1
    branch has the leading q factored out analytically)."""
    q = r / h
    s = sigma(dim) / h**dim
    g1 = (-3.0 + 2.25 * q) / h
    t = 2.0 - q
    g2 = -0.75 * t * t / torch.clamp_min(r, eps)
    g = torch.where(q < 1.0, g1, g2)
    g = torch.where(q < 2.0, g, torch.zeros_like(q))
    return s * g / h


def dW_dh(r, h, dim: int):
    """Partial of W w.r.t. h at fixed r: -(1/h) (d*W + q*dW/dq)."""
    q = r / h
    s = sigma(dim) / h**dim
    w = s * _f(q)
    dwdq = s * _df(q)
    return -(dim * w + q * dwdq) / h

