"""The composition ``wengine.derived_with`` ran before the derived pass's
row gathers and packing became CUDA kernels (``physics/rowpack.py``),
frozen: the reference that ``tests/test_torch_rowpack.py`` and
``chip_smoke.py`` hold the plain versions, the kernels and the pass
against, bit for bit. Importing it changes nothing; it imports no JAX."""
from __future__ import annotations

import torch

from sphax_torch.neighbors import window as win
from sphax_torch.physics import eos as eos_mod
from sphax_torch.physics import kernels as K
from sphax_torch.physics import wengine


def frozen_gather(state, wd, cfg):
    dim = state.dim
    cols = [state.pos, state.vel, state.mass[:, None], state.u[:, None],
            state.h[:, None]]
    fills = [0.0] * (2 * dim) + [0.0, 0.0, 1.0]
    if cfg.mm_visc:
        cols.append(state.alpha[:, None])
        fills.append(1.0)
    g_s = win.gather_sorted_cols(torch.cat(cols, dim=-1), wd, fills)
    pos_s = g_s[:, :dim] + wd.shift_s
    vel_s = g_s[:, dim:2 * dim]
    mass_s = g_s[:, 2 * dim]
    u_s = g_s[:, 2 * dim + 1]
    h_s = g_s[:, 2 * dim + 2]
    alpha_s = g_s[:, 2 * dim + 3] if cfg.mm_visc else None
    return pos_s, vel_s, mass_s, u_s, h_s, alpha_s


def frozen_a_window(pos_s, mass_s, vel_s, fuse_bals):
    return torch.cat([pos_s.T, mass_s[None]]
                     + ([vel_s.T] if fuse_bals else [])).contiguous()


def frozen_c_window(pos_s, vel_s, mass_s, h_s, rho_s, P_s, cs_s, om_s, bf_s,
                     cfg):
    dim = cfg.dim
    invh = 1.0 / h_s
    ci = P_s / (om_s * rho_s * rho_s)
    gc1 = float(K.sigma(dim)) * invh ** (dim + 1)
    gc2 = gc1 * invh
    return torch.cat([pos_s.T, vel_s.T]
                     + [f[None] for f in (mass_s, h_s, invh, rho_s, cs_s,
                                          ci, gc1, gc2)]
                     + ([bf_s[None]] if cfg.visc_factor_on else [])
                     ).contiguous()


def frozen_mirror(wd, u_s, h_s, rho_s, om_s, bf_s, cfg):
    mirrored = torch.stack([h_s, rho_s, om_s, bf_s], dim=-1)[wd.src]
    h_s, rho_s, om_s, bf_s = mirrored.unbind(-1)
    P_s, cs_s = eos_mod.eos(rho_s, u_s, cfg)
    return h_s, rho_s, P_s, cs_s, om_s, bf_s


def frozen_scatter(wd, h_s, rho_s, P_s, cs_s, om_s, du_s, divv_s, acc_s):
    dim = acc_s.shape[-1]
    out = torch.stack([h_s, rho_s, P_s, cs_s, om_s, du_s, divv_s]
                      + list(acc_s.unbind(-1)), dim=-1)[wd.inv]
    return tuple(out[:, k] for k in range(7)) + (out[:, 7:7 + dim],)


def frozen_derived(state, wd, cfg, domain, spec):
    """``wengine.derived_with`` without gravity, as it was before the
    three kernels: the field-taking entries of kernels A and C."""
    pos_s, vel_s, mass_s, u_s, h_s, alpha_s = frozen_gather(state, wd, cfg)
    h_s, rho_s, om_s, bf_s, divv_s = wengine.stage_density(
        wd, spec, cfg, pos_s, vel_s, mass_s, u_s, h_s, alpha_s=alpha_s)
    mirrored = torch.stack([h_s, rho_s, om_s, bf_s], dim=-1)[wd.src]
    h_s, rho_s, om_s, bf_s = mirrored.unbind(-1)
    P_s, cs_s = eos_mod.eos(rho_s, u_s, cfg)
    acc_s, du_s = wengine.stage_forces(wd, spec, cfg, pos_s, vel_s, mass_s,
                                       h_s, rho_s, P_s, cs_s, om_s, bf_s)
    h, rho, P, cs, om, du, divv, acc = frozen_scatter(
        wd, h_s, rho_s, P_s, cs_s, om_s, du_s, divv_s, acc_s)
    return state._replace(h=h, rho=rho, P=P, cs=cs, omega=om, acc=acc,
                          du_dt=du, divv=divv)
