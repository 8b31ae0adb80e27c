"""Plain torch reference of the self-gravitating cloud's step: SPH plus P3M
gravity, for the check.

The SPH part is ``reference.py``'s (the cubic spline in 3D, Newton
iterations for h with kernel A's clamps and the structural cap, density,
the Balsara switch, the Monaghan viscosity, the pressure force); this
module adds the gravity of a periodic box, split at the scale r_s by the
Ewald split of Hockney & Eastwood's P3M as Springel 2005 (MNRAS 364, 1105;
GADGET-2) documents it, and written from that method:

- the long range on an M^3 mesh of the unit box: the mass of every
  particle (all N, wrapped into the box) deposited by cloud-in-cell on
  the nodes at integer multiples of L / M; its real FFT multiplied by the
  Green's function -4 pi G exp(-k^2 r_s^2) / k^2 (the mean dropped),
  divided by W(k)^2, W the CIC window (the product over the axes of
  sinc^2(k_d L / 2M), clamped below at 1e-3), once for the deposit and
  once for the interpolation; the acceleration -grad phi by the spectral
  gradient, and interpolated by cloud-in-cell at the judged rows;
- the short range over every pair with 0 < r <= the window's cutoff (2
  hcap), found on a cell list by the minimum image: -G m_j S(r) (r^2 +
  eps^2)^-3/2 (x_i - x_j) with S(r) = erfc(r / 2 r_s) + r / (r_s sqrt(pi))
  exp(-r^2 / 4 r_s^2);
- r_s = min(grav_rs_cells L / M, cutoff / 4.5).

Departures from the sources, all the configuration's own: the spectral
gradient in place of GADGET-2's four-point finite difference, with the
derivative of each axis's Nyquist mode taken as zero; the short range
summed out to the window's cutoff (about 5.1 r_s at the cloud's sizes) in
place of GADGET-2's 4.5 r_s; Plummer softening of the pair force in place
of GADGET-2's spline softening; the SPH equations of ``reference.py``
in place of Klessen, Burkert & Bate 1998's SPH (their viscosity, their h
and their gravity solver are not stated in this repository).

``acc_abs``, the scale by which the check divides each row's acceleration
gap, adds to the SPH sum of absolute pair terms the sum of the absolute
short-range pair terms, and the rms over the mesh nodes of the mesh
acceleration's magnitude: an FFT's rounding lands on every node in
proportion to the whole field's norm, not to the field at the node, so a
row where the long range nearly cancels still carries the rounding of the
rms.

It imports nothing of the program. ``Arith`` is ``reference.py``'s: float64,
or the control (float32, the operands of every sum over particles, the
deposit's and the interpolation's included, rounded to TF32, and the FFTs
in complex64). There is no driving and no block timestep here:
``rung_tick``, ``drive_modes`` and ``ou_update`` raise.
"""
from __future__ import annotations

import math

import torch

from portbench.reference import (Arith, Grid, density, eos, forces,  # noqa
                                 particle_dt)

_SQRT_PI = math.sqrt(math.pi)


def _refuse(what: str):
    raise NotImplementedError(f"the P3M reference has no {what}: the cloud "
                              "is undriven and runs at global dt")


def rung_tick(*args, **kwargs):
    _refuse("rung tick")


def drive_modes(*args, **kwargs):
    _refuse("driving modes")


def ou_update(*args, **kwargs):
    _refuse("driving")


def split_scale(sph, cutoff: float, box: float) -> float:
    """r_s: the configuration's mesh cells, at most the cutoff / 4.5."""
    return min(float(sph["grav_rs_cells"]) * box / int(sph["grav_mesh"]),
               cutoff / 4.5)


# ---- the long range ---------------------------------------------------------


def _cic(x, box: float, M: int):
    """Cloud-in-cell: ([n, 8] flat node indices, [n, 8] weights) of the
    nodes at multiples of box / M around each point of the periodic box."""
    u = torch.remainder(x * (M / box), M)
    base = torch.floor(u)
    t = u - base
    base = base.long()
    idx, wts = [], []
    for corner in range(8):
        bits = [(corner >> (2 - d)) & 1 for d in range(3)]
        w = torch.ones_like(t[:, 0])
        node = torch.zeros_like(base[:, 0])
        for d, b in enumerate(bits):
            w = w * (t[:, d] if b else 1.0 - t[:, d])
            node = node * M + torch.remainder(base[:, d] + b, M)
        idx.append(node)
        wts.append(w)
    return torch.stack(idx, 1), torch.stack(wts, 1)


def mesh_accel(ar: Arith, x, mass, rows, sph, rs: float, box: float):
    """(acceleration [len(rows), 3] at the rows, rms over the nodes of the
    mesh acceleration's magnitude): the long range of every particle at
    ``x`` (wrapped), on the configuration's mesh."""
    M, G = int(sph["grav_mesh"]), float(sph["G"])
    idx, w = _cic(x, box, M)
    grid = ar.psum(mass.repeat_interleave(8), w.reshape(-1), idx.reshape(-1),
                   M ** 3).reshape(M, M, M)
    cell = box / M
    kf = torch.fft.fftfreq(M, d=cell, dtype=ar.dtype, device=x.device)
    kr = torch.fft.rfftfreq(M, d=cell, dtype=ar.dtype, device=x.device)
    ks = [2.0 * math.pi * k for k in (kf[:, None, None], kf[None, :, None],
                                      kr[None, None, :])]
    k2 = ks[0] ** 2 + ks[1] ** 2 + ks[2] ** 2
    win = torch.ones_like(k2)
    for k in ks:
        a = 0.5 * k * cell
        s = torch.where(a == 0.0, 1.0, torch.sin(a) / torch.where(
            a == 0.0, 1.0, a))
        win = win * s * s
    green = (-4.0 * math.pi * G) * torch.exp(-k2 * rs * rs) / torch.where(
        k2 == 0.0, 1.0, k2) / torch.clamp_min(win, 1e-3) ** 2
    green[0, 0, 0] = 0.0
    phik = torch.fft.rfftn(grid) * green / (cell ** 3)
    del grid, green
    nyq = math.pi / cell
    acc_nodes = []
    for k in ks:
        # the derivative of an axis's Nyquist mode is taken as zero
        kd = torch.where(torch.abs(torch.abs(k) - nyq) < 1e-6 * nyq, 0.0, k)
        acc_nodes.append(torch.fft.irfftn(-1j * kd * phik, s=(M, M, M))
                         .reshape(-1))
    del phik
    rms = torch.sqrt(torch.mean(sum(a * a for a in acc_nodes)))
    ir, wr = idx[rows], w[rows]
    m = len(rows)
    own = torch.arange(m, device=x.device).repeat_interleave(8)
    acc = torch.stack([ar.psum(wr.reshape(-1), a[ir.reshape(-1)], own, m)
                       for a in acc_nodes], dim=-1)
    return acc, rms


# ---- the short range --------------------------------------------------------


def short_accel(ar: Arith, x, mass, rows, sph, rs: float, cutoff: float,
                box: float):
    """(acceleration [len(rows), 3], sum of the absolute pair terms [len(
    rows)]) of every pair with 0 < r <= cutoff."""
    G, eps = float(sph["G"]), float(sph["grav_eps"])
    i, j, dx, r = Grid(x, cutoff * (1.0 + 1e-9), box).pairs(rows)
    keep = (r > 0.0) & (r <= cutoff)
    i, j, dx, r = i[keep], j[keep], dx[keep], r[keep]
    q = r / (2.0 * rs)
    screen = torch.special.erfc(q) + r / (rs * _SQRT_PI) * torch.exp(-q * q)
    coef = G * mass[j] * screen * (r * r + eps * eps) ** -1.5
    m = len(rows)
    return (-ar.psum(coef[:, None], dx, i, m),
            ar.psum(torch.abs(coef), r, i, m))


# ---- a derived pass and a KDK step ------------------------------------------


def _cast(arrays: dict, ar: Arith) -> dict:
    return {k: (v.to(ar.dtype) if torch.is_floating_point(v) else v)
            for k, v in arrays.items()}


def derived(ar, x, vel, mass, u, rows, h0, sph, hcap: float, box: float):
    """The derived pass at positions ``x`` (wrapped) for ``rows``: the SPH
    stages of ``reference.py`` on the rows and their neighbours, then the
    forces of the rows with the P3M gravity added."""
    radius = 2.0 * min(hcap, 1.15 * float(h0.max()))
    while True:
        grid = Grid(x, radius, box)
        pr = grid.pairs(rows)
        need = torch.unique(torch.cat([rows, pr[1]]))
        d = density(ar, grid.pairs(need), need, x, vel, mass, u[need],
                    h0[need], sph, hcap)
        if radius >= 2.0 * hcap or 2.0 * d["h_peak"] < radius:
            break
        radius = 2.0 * hcap
    n = x.shape[0]
    f = {}
    for k in ("h", "rho", "omega", "bf", "divv", "div_abs"):
        f[k] = x.new_full((n,), float("nan"))
        f[k][need] = d[k]
    f["P"], f["cs"] = x.new_full((n,), float("nan")), x.new_full(
        (n,), float("nan"))
    f["P"][need], f["cs"][need] = eos(f["rho"][need], u[need], sph)
    out = forces(ar, pr, rows, vel, mass, f, sph)
    out.update({k: f[k][rows] for k in ("h", "rho", "omega", "P", "cs",
                                         "divv", "div_abs")})
    cutoff = 2.0 * hcap
    rs = split_scale(sph, cutoff, box)
    a_short, abs_short = short_accel(ar, x, mass, rows, sph, rs, cutoff, box)
    a_mesh, rms = mesh_accel(ar, x, mass, rows, sph, rs, box)
    out["acc"] = out["acc"] + a_short + a_mesh
    out["acc_abs"] = out["acc_abs"] + abs_short + rms
    return out


def derived_start(ar, ics, rows, sph, hcap, box):
    """The set-up's derived pass on the ICs (dict pos, vel, mass, u, h)."""
    s = _cast(ics, ar)
    return derived(ar, torch.remainder(s["pos"], box), s["vel"], s["mass"],
                   s["u"], rows, s["h"], sph, hcap, box)


def kdk_step(ar, st, rows, sph, hcap, box, drive=None):
    """One global KDK step from the state ``st`` (pos, vel, mass, u, h, cs,
    acc, du_dt) for ``rows``: dt from the state, half-kick, drift, the
    derived pass at the new positions, half-kick."""
    if drive is not None:
        _refuse("driving")
    s = _cast(st, ar)
    dt = particle_dt(s["h"], s["cs"], s["acc"], sph).min()
    v_h = s["vel"] + 0.5 * dt * s["acc"]
    u_h = torch.clamp_min(s["u"] + 0.5 * dt * s["du_dt"], sph["u_floor"])
    x = torch.remainder(s["pos"] + dt * v_h, box)
    out = derived(ar, x, v_h, s["mass"], u_h, rows, s["h"], sph, hcap, box)
    out["vel"] = v_h[rows] + 0.5 * dt * out["acc"]
    out["u"] = torch.clamp_min(u_h[rows] + 0.5 * dt * out["du_dt"],
                               sph["u_floor"])
    out["pos"], out["dt"] = x[rows], dt
    return out
