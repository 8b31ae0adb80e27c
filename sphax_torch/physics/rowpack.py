"""The derived pass's row gathers and packing: wrappers and plain versions.

This module owns the sorted-row format. Every derived pass packs through
it: ``wengine.derived_with`` (the global step and, over its closers, the
rung tick), the rung path's viscosity-factor seed and the shard passes of
``dist/``. The one-device pass moves the state between its original order
and kernels A's and C's feature-major sorted windows in three steps:

``gather_a``     original-order pos, vel, m, u, h (and alpha) through
                 ``wd.g`` into A's window [pos + shift_s, m, vel]
                 ([2 dim + 1, Ns]; A reads the first dim + 1 rows without
                 Balsara) and the sorted h0, u (and alpha); pad rows take
                 0, with 1 for h and alpha. A shard passes its combined
                 arrays, local rows then ghost slots
``gather_c``     C's window [pos, vel, m, h, 1/h, rho, cs, ci, gc1, gc2
                 (, bf)] ([2 dim + 8 (+ 1), Ns]): positions, velocities and
                 mass from A's window, the rest from the owner row
                 ``wd.src`` (the owner mirror), with kernel C's four
                 hoisted fields
``scatter_out``  the outputs through ``wd.inv`` back to original order

Each chooses by the device of its input tensors, as the kernel wrappers
do: a CUDA tensor launches the hand-written CUDA kernel
(``sphax_torch/csrc/rowpack.cu``), a CPU tensor runs the plain torch
version beside it (``*_plain``): the composition the derived pass ran
before the kernels, which they are held against bit for bit on the card.

The sorted h, rho, om, bf, P and cs that ``gather_c`` takes are those of
the stage's own rows, unmirrored (on a rung tick the current-best ones:
fresh on closing rows, stale elsewhere); P and cs come from the EOS of
those rows. u is the owner's on every real and ghost row, so mirroring the EOS
equals the EOS of the mirrored rows there. Pad rows (zero mass) mirror a
row the build leaves unspecified: their C inputs are don't-care, as their
outputs are. ``scatter_out`` reads owner rows only, where the mirror is
the identity (``src[inv[i]] == inv[i]``).
"""
from __future__ import annotations

import torch

from sphax_torch.configs import SPHConfig
from sphax_torch.neighbors import window as win
from sphax_torch.neighbors.window import WindowData
from sphax_torch.physics import kernels as K
from sphax_torch.physics.cuda_call import (check_fields, check_index,
                                           launch, plain_here, ptr)

# Launches of each CUDA kernel; a wrapper adds one where it launches.
LAUNCHES = {"rowpack_gather_a": 0, "rowpack_gather_c": 0,
            "rowpack_scatter_out": 0}


def c_rows(dim: int, use_bf: bool) -> int:
    """Rows of kernel C's window."""
    return 2 * dim + 8 + int(use_bf)


# ---------------------------------------------------------------------------
# plain torch versions (CPU path, and the reference on the card)
# ---------------------------------------------------------------------------


def gather_a_plain(wd: WindowData, pos, vel, mass, u, h, alpha=None):
    """Returns (win [2 dim + 1, Ns], h0_s, u_s, alpha_s or None): one packed
    sorted gather, the image shifts added back to the positions, then A's
    feature-major rows."""
    dim = pos.shape[1]
    cols = [pos, vel, mass[:, None], u[:, None], h[:, None]]
    fills = [0.0] * (2 * dim) + [0.0, 0.0, 1.0]
    if alpha is not None:
        cols.append(alpha[:, None])
        fills.append(1.0)
    g_s = win.gather_sorted_cols(torch.cat(cols, dim=-1), wd, fills)
    pos_s = g_s[:, :dim] + wd.shift_s
    vel_s = g_s[:, dim:2 * dim]
    mass_s = g_s[:, 2 * dim]
    win_a = torch.cat([pos_s.T, mass_s[None], vel_s.T]).contiguous()
    alpha_s = g_s[:, 2 * dim + 3] if alpha is not None else None
    return win_a, g_s[:, 2 * dim + 2], g_s[:, 2 * dim + 1], alpha_s


def a_fields(win_a):
    """(pos_s [Ns, dim], vel_s [Ns, dim], mass_s [Ns]): views of A's
    window, in the order the density and force stages take them."""
    dim = win_a.shape[0] // 2
    return win_a[:dim].T, win_a[dim + 1:].T, win_a[dim]


def mirror_plain(wd: WindowData, h_s, rho_s, om_s, bf_s, P_s, cs_s):
    """The owner mirror of the sorted fields kernel C reads beyond A's
    window: one packed gather through ``wd.src``; (h, rho, P, cs, om,
    bf)."""
    m = torch.stack([h_s, rho_s, om_s, bf_s, P_s, cs_s], dim=-1)[wd.src]
    h, rho, om, bf, P, cs = m.unbind(-1)
    return h, rho, P, cs, om, bf


def pack_c(pos_s, vel_s, mass_s, h_s, rho_s, P_s, cs_s, om_s, bf_s,
           cfg: SPHConfig):
    """Kernel C's window from owner-correct sorted fields: the hoisted
    per-particle fields, as the Pallas kernel ships them, then one
    feature-major concatenation (``bf_s`` only when cfg.visc_factor_on).
    Kernel C's wrapper packs its fields with it."""
    dim = cfg.dim
    invh = 1.0 / h_s
    ci = P_s / (om_s * rho_s * rho_s)
    gc1 = float(K.sigma(dim)) * invh ** (dim + 1)
    gc2 = gc1 * invh
    # SoA [F, Ns]: the dim positions and velocities, then
    # m h invh rho cs ci gc1 gc2 (bf)
    return torch.cat([pos_s.T, vel_s.T]
                     + [f[None] for f in (mass_s, h_s, invh, rho_s, cs_s,
                                          ci, gc1, gc2)]
                     + ([bf_s[None]] if cfg.visc_factor_on else [])
                     ).contiguous()


def gather_c_plain(win_a, wd: WindowData, cfg: SPHConfig, h_s, rho_s, om_s,
                   bf_s, P_s, cs_s):
    """Returns (win [2 dim + 8 (+ 1), Ns], (h, rho, P, cs, om, bf)
    mirrored): the owner mirror, then C's window."""
    dim = cfg.dim
    h, rho, P, cs, om, bf = mirrored = mirror_plain(wd, h_s, rho_s, om_s,
                                                    bf_s, P_s, cs_s)
    return pack_c(win_a[:dim].T, win_a[dim + 1:].T, win_a[dim], h, rho, P,
                  cs, om, bf, cfg), mirrored


def scatter_out_plain(wd: WindowData, h_s, rho_s, P_s, cs_s, om_s, du_s,
                      divv_s, acc_s):
    """One packed unsort gather through ``wd.inv``; (h, rho, P, cs, om,
    du, divv, acc) in original order."""
    dim = acc_s.shape[-1]
    out = torch.stack([h_s, rho_s, P_s, cs_s, om_s, du_s, divv_s]
                      + list(acc_s.unbind(-1)), dim=-1)[wd.inv]
    return tuple(out[:, k] for k in range(7)) + (out[:, 7:7 + dim],)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def gather_a(wd: WindowData, pos, vel, mass, u, h, alpha=None):
    """Kernel A's window from original-order fields ([n, dim] pos and vel,
    [n] the rest; ``alpha`` only with the Morris-Monaghan switch): (win
    [2 dim + 1, Ns], h0_s, u_s, alpha_s or None)."""
    if plain_here(pos):
        return gather_a_plain(wd, pos, vel, mass, u, h, alpha)
    (n, dim), Ns = pos.shape, wd.g.shape[0]
    if dim not in (1, 2, 3):
        raise NotImplementedError(f"rowpack is built for dim 1, 2 and 3, "
                                  f"not {dim}")
    pos, vel, mass, u, h = (t.contiguous() for t in (pos, vel, mass, u, h))
    fields = dict(pos=(pos, n), vel=(vel, (n, dim)), mass=(mass, n),
                  u=(u, n), h=(h, n), shift_s=(wd.shift_s, Ns))
    if alpha is not None:
        alpha = alpha.contiguous()
        fields["alpha"] = (alpha, n)
    check_fields(pos, fields, contiguous=True)
    check_index(pos, "g", wd.g, (Ns,))
    win_a = pos.new_empty((2 * dim + 1, Ns))
    h_s, u_s = pos.new_empty(Ns), pos.new_empty(Ns)
    alpha_s = pos.new_empty(Ns) if alpha is not None else None
    launch(LAUNCHES, "rowpack_gather_a", pos.dtype, *map(ptr, (
        pos, vel, mass, u, h, alpha, wd.g, wd.shift_s)), n, Ns, dim,
        int(alpha is not None), *map(ptr, (win_a, h_s, u_s, alpha_s)))
    return win_a, h_s, u_s, alpha_s


def gather_c(win_a, wd: WindowData, cfg: SPHConfig, h_s, rho_s, om_s, bf_s,
             P_s, cs_s):
    """Kernel C's window: (win [2 dim + 8 (+ 1), Ns], mirrored). On the CPU
    ``mirrored`` holds the owner-mirrored (h, rho, P, cs, om, bf) that the
    plain kernel C reads; on a card it is six Nones, since kernel C reads
    the window alone."""
    if plain_here(win_a):
        return gather_c_plain(win_a, wd, cfg, h_s, rho_s, om_s, bf_s, P_s,
                              cs_s)
    dim, Ns = cfg.dim, wd.src.shape[0]
    use_bf = bool(cfg.visc_factor_on)
    fields = dict(win_a=(win_a, (2 * dim + 1, Ns)), h_s=(h_s, Ns),
                  rho_s=(rho_s, Ns), om_s=(om_s, Ns), P_s=(P_s, Ns),
                  cs_s=(cs_s, Ns))
    if use_bf:
        fields["bf_s"] = (bf_s, Ns)
    check_fields(win_a, fields, contiguous=True)
    check_index(win_a, "src", wd.src, (Ns,))
    win_c = win_a.new_empty((c_rows(dim, use_bf), Ns))
    launch(LAUNCHES, "rowpack_gather_c", win_a.dtype, *map(ptr, (
        win_a, wd.src, h_s, rho_s, om_s, bf_s if use_bf else None, P_s,
        cs_s)), Ns, dim, int(use_bf), float(K.sigma(dim)), ptr(win_c))
    return win_c, (None,) * 6


def scatter_out(wd: WindowData, h_s, rho_s, P_s, cs_s, om_s, du_s, divv_s,
                acc_s):
    """The outputs in original order: (h, rho, P, cs, om, du, divv, acc);
    separate contiguous tensors from the kernel, columns of one packed
    array from the plain version."""
    if plain_here(acc_s):
        return scatter_out_plain(wd, h_s, rho_s, P_s, cs_s, om_s, du_s,
                                 divv_s, acc_s)
    n, (Ns, dim) = wd.inv.shape[0], acc_s.shape
    scalars = dict(h_s=h_s, rho_s=rho_s, P_s=P_s, cs_s=cs_s, om_s=om_s,
                   du_s=du_s, divv_s=divv_s)
    check_fields(acc_s, {k: (v, Ns) for k, v in scalars.items()}
                 | dict(acc_s=(acc_s, Ns)), contiguous=True)
    check_index(acc_s, "inv", wd.inv, (n,))
    outs = [acc_s.new_empty(n) for _ in range(7)] + [
        acc_s.new_empty((n, dim))]
    launch(LAUNCHES, "rowpack_scatter_out", acc_s.dtype, ptr(wd.inv),
           *map(ptr, scalars.values()), ptr(acc_s), n, dim, *map(ptr, outs))
    return tuple(outs)
