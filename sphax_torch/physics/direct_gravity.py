"""Kernel G, the open-boundary direct-sum gravity: wrapper and plain version.

``gravity`` replaces the Pallas TPU kernel
``sphax.physics.pallas_kernels.gravity``: acc_i = -G sum_j m_j
(r_ij^2 + eps^2)^-3/2 dx_ij over all pairs, Plummer-softened, with no
periodic min-image. Self-pairs give exactly zero because dx = 0, which
needs ``grav_eps > 0``.

A CUDA tensor launches the hand-written kernel
(``sphax_torch/csrc/gravity_kernel.cu``) or raises; a CPU tensor runs the
plain torch version beside it, ``gravity_plain``, which is also what the
kernel is held against on the card.
"""
from __future__ import annotations

import torch

from sphax_torch.configs import SPHConfig
from sphax_torch.physics import window_kernels as wk


def _check_eps(cfg: SPHConfig):
    if float(cfg.grav_eps) <= 0.0:
        raise ValueError("cfg.grav_eps must be > 0 for the direct-sum "
                         "gravity kernel (softening also guards the "
                         "self-pair)")


def gravity_plain(pos, mass, cfg: SPHConfig, rows=None):
    """Row-blocked torch direct sum, the same math as the kernel. With
    ``rows`` (an index tensor) only those rows are computed, against all N
    columns: a sample of a large N at a fraction of the cost."""
    _check_eps(cfg)
    from sphax_torch.physics.clist import _blocked

    n = pos.shape[0]
    eps2 = float(cfg.grav_eps) ** 2

    def body(pos_i):
        dx = pos_i[:, None, :] - pos[None, :, :]
        r2 = torch.sum(dx * dx, -1) + eps2
        inv = mass[None, :] * torch.rsqrt(r2) / r2
        return -float(cfg.G) * torch.sum(inv[..., None] * dx, dim=-2)

    # keep each block's [B, N, 3] intermediates near 2^24 elements
    return _blocked(body, pos if rows is None else pos[rows],
                    max(1, min(n, (1 << 24) // max(n, 1))))


def gravity(pos, mass, cfg: SPHConfig):
    """Kernel G. pos [N, 3], mass [N] -> acc [N, 3]."""
    _check_eps(cfg)
    if pos.device.type == "cpu":
        return gravity_plain(pos, mass, cfg)
    if pos.device.type != "cuda":
        raise ValueError(f"no kernel for device {pos.device}")
    n, dim = pos.shape
    if dim != 3:
        raise NotImplementedError("the CUDA gravity kernel is built for "
                                  "dim=3 only")
    if pos.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"unsupported dtype {pos.dtype}")
    if (mass.device != pos.device or mass.dtype != pos.dtype
            or tuple(mass.shape) != (n,)):
        raise ValueError(f"mass must be a [{n}] {pos.dtype} tensor on "
                         f"{pos.device}")
    acc = torch.empty((n, 3), dtype=pos.dtype, device=pos.device)
    if n == 0:
        return acc
    # SoA [4, N]: x, y, z, m
    src = torch.cat([pos.T, mass[None]]).contiguous()
    wk._launch("gravity", pos.dtype, wk._ptr(src), n,
               float(cfg.grav_eps) ** 2, float(cfg.G), wk._ptr(acc))
    return acc
