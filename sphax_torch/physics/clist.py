"""Direct-sum gravity over all pairs (torch twin of
``sphax.physics.clist.gravity_dense``).

Only this function is ported from ``sphax.physics.clist``: the cell-list
engine itself exists in the JAX package as a CPU-tier speed tier and has no
counterpart here. ``gravity_dense`` is the min-image direct sum that the
window engine uses for ``grav_solver="direct"`` on a periodic box; it is
plain torch, as it is jnp in the JAX package.
"""
from __future__ import annotations

import torch

from sphax_torch.configs import SPHConfig
from sphax_torch.core.state import Domain
from sphax_torch.physics import pairs


def _blocked(body, rows, block: int):
    """Apply ``body(row_block)`` to [block]-row slices of ``rows`` ([N, ...])
    and concatenate the results back to [N, ...]."""
    return torch.cat([body(rows[i:i + block])
                      for i in range(0, rows.shape[0], block)])


def gravity_dense(pos_s, mass_s, cfg: SPHConfig, domain: Domain,
                  block: int = 128):
    """Direct-sum softened gravity, row-blocked over ALL pairs (long-range)."""

    def body(pos_i):
        dx = domain.displacement(pos_i[:, None, :] - pos_s[None, :, :])
        r = torch.sqrt(torch.sum(dx * dx, -1))
        g = pairs.gravity_terms(dx, r, mass_s[None, :], cfg)
        return -torch.sum(g[..., None] * dx, dim=-2)

    return _blocked(body, pos_s, block)
