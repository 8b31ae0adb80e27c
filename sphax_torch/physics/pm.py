r"""P3M self-gravity: FFT mesh long range + screened pair short range
(torch twin of ``sphax.physics.pm``).

The Ewald split

    1/r = erfc(r / 2 r_s) / r   +   erf(r / 2 r_s) / r
          \__ short range __/       \__ long range __/

puts the short-range force G m_j S(r) / r^2, with
S(r) = erfc(r/2rs) + (r / (rs sqrt(pi))) exp(-r^2 / 4 rs^2), on the window
candidates (fused into kernel C, ``window_kernels.forces(grav=...)``), and
the long-range force on a CIC mesh solved by FFT:

- periodic box: the k-space Green's function -4 pi G exp(-k^2 rs^2) / k^2
  with the W^2 CIC deconvolution and the spectral gradient i k;
- open box: the Hockney-Eastwood zero-padded convolution with the sampled
  free-space force kernels.

The solve is ``torch.fft``. The CIC deposit and interpolation choose by the
device of the positions, as the other kernel wrappers do: a CUDA tensor
launches the hand-written kernels of ``sphax_torch/csrc/cic.cu`` (one pass
over the particles each; the deposit's atomics make its sums' order, not
their terms, vary from run to run), a CPU tensor runs the plain torch
versions beside them (``_deposit_plain``, an ``index_add_`` a corner on the
flattened grid, and ``_interp_plain``), which the kernels are held to on
the card: the interpolation bit for bit. ``mesh_accel_sorted``
is the JAX package's sorted-order CIC (``pm_sorted``: brick matrix
products over the window structure's sorted rows), which worked around the
TPU's serialized scatter; on a card the scatter mesh is the cheaper one,
and every engine runs it.
"""
from __future__ import annotations

import math

import torch

from sphax_torch.configs import SPHConfig
from sphax_torch.core.state import Domain
from sphax_torch.physics.cuda_call import (check_fields, launch,
                                           plain_here, ptr)

_SQRT_PI = math.sqrt(math.pi)

# mesh solves of this process (``mesh_accel`` calls), beside
# ``neighbors.window.BUILDS``: a host integer, no device read
SOLVES = {"n": 0}
# Launches of each CUDA kernel; a wrapper adds one where it launches.
LAUNCHES = {"cic_deposit": 0, "cic_interp": 0}


def short_range_factor(r, rs, eps):
    """f(r) with acc_i = -G sum_j m_j f(r_ij) dx_ij (screened, softened)."""
    x = r / (2.0 * rs)
    screen = torch.special.erfc(x) + (r / (rs * _SQRT_PI)) * torch.exp(-x * x)
    return screen * (r * r + eps * eps) ** -1.5


def _cic_weights(pos, lo, cell, M: int, periodic: bool):
    """CIC node weights: returns (i0 [N, D] int32, frac [N, D]) with the
    node grid at lo + k * cell (k = 0..M-1)."""
    u = (pos - lo) / cell
    if periodic:
        u = torch.remainder(u, M)
        i0 = torch.floor(u).to(torch.int32)
        frac = u - i0
        i0 = torch.remainder(i0, M)
    else:
        # clip FIRST, then take the fraction from the clipped node: the
        # outermost cell near a hi face deposits with weights referenced to
        # its actual left node
        i0 = torch.clamp(torch.floor(u).to(torch.int32), 0, M - 2)
        frac = torch.clamp(u - i0, 0.0, 1.0)
    return i0, frac


def _corners(i0, f, M: int, periodic: bool):
    """The 8 CIC corners in (dx, dy, dz) order: (flat node index, weight)."""
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = ((f[:, 0] if dx else 1 - f[:, 0])
                     * (f[:, 1] if dy else 1 - f[:, 1])
                     * (f[:, 2] if dz else 1 - f[:, 2]))
                ix = i0[:, 0] + dx
                iy = i0[:, 1] + dy
                iz = i0[:, 2] + dz
                if periodic:
                    ix, iy, iz = ix % M, iy % M, iz % M
                yield (ix.long() * M + iy) * M + iz, w


def _deposit_plain(pos, mass, lo, cell, M: int, periodic: bool):
    """CIC mass deposit onto an [M, M, M] node grid."""
    i0, f = _cic_weights(pos, lo, cell, M, periodic)
    grid = pos.new_zeros(M * M * M)
    for flat, w in _corners(i0, f, M, periodic):
        grid.index_add_(0, flat, mass * w)
    return grid.reshape(M, M, M)


def _interp_plain(grids, pos, lo, cell, M: int, periodic: bool):
    """CIC interpolation of [D][M, M, M] grids back to particles -> [N, D]."""
    i0, f = _cic_weights(pos, lo, cell, M, periodic)
    corners = list(_corners(i0, f, M, periodic))
    out = []
    for g in grids:
        flat_g = g.reshape(-1)
        acc = 0.0
        for flat, w in corners:
            acc = acc + w * flat_g[flat]
        out.append(acc)
    return torch.stack(out, dim=-1)


def _check_box(pos, lo, cell):
    """Contiguous pos [N, 3], lo and cell [3] of pos's device and dtype."""
    pos, lo, cell = pos.contiguous(), lo.contiguous(), cell.contiguous()
    check_fields(pos, dict(pos=(pos, (pos.shape[0], 3)), lo=(lo, (3,)),
                           cell=(cell, (3,))), contiguous=True)
    return pos, lo, cell


def _deposit(pos, mass, lo, cell, M: int, periodic: bool):
    """CIC mass deposit onto an [M, M, M] node grid: the kernel
    ``cic_deposit`` on a CUDA tensor, ``_deposit_plain`` on a CPU one."""
    if pos.shape[1] != 3:
        raise ValueError("the P3M mesh is 3D")
    if plain_here(pos):
        return _deposit_plain(pos, mass, lo, cell, M, periodic)
    pos, lo, cell = _check_box(pos, lo, cell)
    mass = mass.contiguous()
    check_fields(pos, dict(mass=(mass, (pos.shape[0],))), contiguous=True)
    grid = pos.new_zeros(M * M * M)
    launch(LAUNCHES, "cic_deposit", pos.dtype, *map(ptr, (pos, mass, lo,
           cell)), pos.shape[0], M, int(periodic), ptr(grid))
    return grid.reshape(M, M, M)


def _interp(grids, pos, lo, cell, M: int, periodic: bool):
    """CIC interpolation of a stacked [D, M, M, M] tensor of grids (or a
    sequence of D [M, M, M] grids; D at most 3 on a card) back to
    particles -> [N, D]: the kernel ``cic_interp`` on a CUDA tensor,
    ``_interp_plain`` on a CPU one."""
    if plain_here(pos):
        return _interp_plain(grids, pos, lo, cell, M, periodic)
    pos, lo, cell = _check_box(pos, lo, cell)
    grids = (grids if torch.is_tensor(grids)
             else torch.stack(list(grids))).contiguous()
    G = grids.shape[0]
    if not 1 <= G <= 3:
        raise ValueError(f"cic_interp reads 1 to 3 grids, not {G}")
    check_fields(pos, dict(grids=(grids, (G, M, M, M))), contiguous=True)
    out = pos.new_empty((pos.shape[0], G))
    launch(LAUNCHES, "cic_interp", pos.dtype, *map(ptr, (pos, lo, cell,
           grids)), pos.shape[0], M, G, int(periodic), ptr(out))
    return out


def rs_traced(cfg: SPHConfig, domain: Domain, dtype, cutoff=None):
    """Split scale r_s as a 0-d tensor on the domain's device. With the
    short range on a neighbour structure of search radius ``cutoff``, r_s
    shrinks so the screened tail (4.5 r_s) always fits inside it."""
    M = int(cfg.grav_mesh)
    rs = float(cfg.grav_rs_cells) * (domain.extent.to(dtype) / M).min()
    if cutoff is not None:
        rs = torch.minimum(rs, torch.full_like(rs, cutoff) / 4.5)
    return rs


def _periodic_phihat(grid, domain: Domain, G: float, rs, M: int):
    """The periodic solve in k-space: (phi_hat, (kx, ky, kz), cell volume),
    with phi_hat = -4 pi G exp(-k^2 rs^2) / k^2 / W^2 times the mass
    grid's transform (the mean dropped), W the CIC window (clamped at
    1e-3), so that ifftn(phi_hat) / volume is the Gaussian-filtered
    potential on the nodes."""
    dtype, dev = grid.dtype, grid.device
    cell = domain.extent.to(dtype) / M
    freq = torch.fft.fftfreq(M, dtype=dtype, device=dev)
    k1 = [2 * math.pi * freq / cell[d] for d in range(3)]
    kx = k1[0][:, None, None]
    ky = k1[1][None, :, None]
    kz = k1[2][None, None, :]
    k2 = kx * kx + ky * ky + kz * kz
    k2 = torch.where(k2 == 0.0, 1.0, k2)

    def sinc(x):
        return torch.where(x == 0.0, 1.0,
                           torch.sin(x) / torch.where(x == 0.0, 1.0, x))
    # W is the CIC kernel transform (per-axis sinc^2); one factor each
    # is deconvolved for the deposit and the interpolation: W^2 total
    W = (sinc(0.5 * kx * cell[0]) * sinc(0.5 * ky * cell[1])
         * sinc(0.5 * kz * cell[2])) ** 2
    W2 = torch.clamp_min(W, 1e-3) ** 2
    mhat = torch.fft.fftn(grid)
    phihat = (-4.0 * math.pi * G * torch.exp(-k2 * rs * rs) / k2
              / W2) * mhat
    phihat[0, 0, 0] = 0.0
    return phihat, (kx, ky, kz), torch.prod(cell)


def _solve_grids(grid, domain: Domain, G: float, rs, M: int, periodic: bool):
    """Poisson solve: mass grid -> [3, M, M, M] acceleration node grids
    (periodic: k-space Green's function; open: Hockney zero-padded
    convolution with sampled free-space force kernels). The FFTs run in
    the complex type of ``grid``'s precision."""
    dtype, dev = grid.dtype, grid.device
    ext = domain.extent.to(dtype)
    cell = ext / M
    if periodic:
        phihat, ks, vol = _periodic_phihat(grid, domain, G, rs, M)
        return torch.stack(
            [torch.fft.ifftn(-1j * kd * phihat).real / vol for kd in ks])
    P = 2 * M
    gpad = grid.new_zeros((P, P, P))
    gpad[:M, :M, :M] = grid
    ax = torch.arange(P, device=dev)
    coord = [torch.where(ax < M, ax, ax - P).to(dtype) * cell[d]
             for d in range(3)]
    rx = coord[0][:, None, None]
    ry = coord[1][None, :, None]
    rz = coord[2][None, None, :]
    r2 = rx * rx + ry * ry + rz * rz
    r = torch.sqrt(torch.clamp_min(r2, 1e-30))
    x = r / (2.0 * rs)
    fmag = (torch.special.erf(x) / torch.clamp_min(r2 * r, 1e-30)
            - torch.exp(-x * x) / (rs * _SQRT_PI * torch.clamp_min(r2, 1e-30)))
    fmag = torch.where(r2 <= 0.0, 0.0, fmag)
    mhat = torch.fft.fftn(gpad)
    return torch.stack(
        [torch.fft.ifftn(mhat * torch.fft.fftn(rd * fmag)).real[:M, :M, :M]
         * (-G) for rd in (rx, ry, rz)])


def _solve_and_interp(grid, pos_eval, domain: Domain, G: float, rs, M: int,
                      periodic: bool):
    """Shared back half: Green's function / Hockney solve + CIC interp."""
    dtype = pos_eval.dtype
    cell = domain.extent.to(dtype) / M
    grids = _solve_grids(grid, domain, G, rs, M, periodic)
    return _interp(grids, pos_eval, domain.lo.to(dtype), cell, M, periodic)


def mesh_accel(pos, mass, cfg: SPHConfig, domain: Domain, rs=None,
               group=None):
    """Long-range (Gaussian-filtered) gravitational acceleration [N, D].
    Positions are wrapped into the box first: ``wengine.simulate`` drifts
    them unwrapped between rebuilds.

    ``group`` (a ``sphax_torch.dist.comm.Comm``): each rank deposits ITS
    particles on a full copy of the global grid and one all-reduce (SUM)
    makes the grids identical; every rank then solves the (small) grid
    itself and interpolates back to its own particles. This is the
    distributed P3M mesh of ``sphax_torch.dist.wslab``."""
    M = int(cfg.grav_mesh)
    dtype = pos.dtype
    if rs is None:
        rs = rs_traced(cfg, domain, dtype)
    per = domain.periodic_axes(pos.shape[1])
    periodic = all(per)
    if not periodic and any(per):
        raise NotImplementedError("P3M needs fully periodic or fully open "
                                  "box")
    lo = domain.lo.to(dtype)
    cell = domain.extent.to(dtype) / M
    pos_dep = domain.wrap(pos)
    SOLVES["n"] += 1
    grid = _deposit(pos_dep, mass, lo, cell, M, periodic)
    if group is not None:
        grid = group.all_reduce_sum(grid)
    return _solve_and_interp(grid, pos_dep, domain, float(cfg.G), rs, M,
                             periodic)


def mesh_accel_sorted(pos_s, mass_s, real_s, cfg: SPHConfig,
                      domain: Domain, plan, rs=None, group=None):
    """``mesh_accel`` over the SORTED window rows (ghost and pad rows
    masked off by ``real_s``) through ``pm_sorted``'s brick products.
    Returns ([Ns, 3] acceleration at the sorted rows, the fallback rows
    dropped past ``plan.cap``; callers raise on it as on h_capped).
    ``group``: the distributed mesh, as in ``mesh_accel``."""
    from sphax_torch.physics import pm_sorted

    M = int(cfg.grav_mesh)
    dtype = pos_s.dtype
    if rs is None:
        rs = rs_traced(cfg, domain, dtype)
    per = domain.periodic_axes(pos_s.shape[1])
    periodic = all(per)
    if not periodic and any(per):
        raise NotImplementedError("P3M needs fully periodic or fully open "
                                  "box")
    w = torch.where(real_s, mass_s, 0.0)
    grid, d1 = pm_sorted.deposit_sorted(pos_s, w, domain, M, periodic, plan)
    if group is not None:
        grid = group.all_reduce_sum(grid)
    grids = _solve_grids(grid, domain, float(cfg.G), rs, M, periodic)
    acc, d2 = pm_sorted.interp_sorted(grids, pos_s, real_s, domain, M,
                                      periodic, plan)
    return acc, d1 + d2


def rs_value(cfg: SPHConfig, domain: Domain) -> float:
    """The split scale r_s (length units, on the host)."""
    return float(cfg.grav_rs_cells) * float(domain.extent.min()) / int(
        cfg.grav_mesh)


def r_cut(cfg: SPHConfig, domain: Domain) -> float:
    """Short-range cutoff: erfc screening < ~2e-3 beyond 4.5 r_s."""
    return 4.5 * rs_value(cfg, domain)


def short_accel_dense(pos, mass, cfg: SPHConfig, domain: Domain,
                      block: int = 128):
    """Screened short-range pair force, blocked over ALL pairs (small N /
    validation path; the window engine computes the same sum over its
    candidates)."""
    from sphax_torch.physics.clist import _blocked

    rs = rs_traced(cfg, domain, pos.dtype)
    eps = float(cfg.grav_eps)

    def body(pos_i):
        dx = domain.displacement(pos_i[:, None, :] - pos[None, :, :])
        r = torch.sqrt(torch.sum(dx * dx, -1))
        f = short_range_factor(r, rs, eps) * mass[None, :]
        # self-pair: dx = 0 kills it, but mask so eps ~ 0 stays exact too
        f = torch.where(r > 0.0, f, 0.0)
        return -float(cfg.G) * torch.sum(f[..., None] * dx, dim=-2)

    return _blocked(body, pos, block)


def p3m_accel_dense(pos, mass, cfg: SPHConfig, domain: Domain):
    """Full P3M acceleration with the dense short-range path."""
    return (mesh_accel(pos, mass, cfg, domain)
            + short_accel_dense(pos, mass, cfg, domain))


# ---- the P3M potential energy (periodic box) --------------------------------


def mesh_potential(pos, mass, cfg: SPHConfig, domain: Domain, rs):
    """The long-range (Gaussian-filtered) potential at each particle [N] on
    a periodic box: ``mesh_accel``'s deposit and Green's function, without
    the gradient, interpolated back by CIC. It holds each particle's own
    long-range potential, about -G m_i / (r_s sqrt(pi))."""
    M = int(cfg.grav_mesh)
    dtype = pos.dtype
    lo = domain.lo.to(dtype)
    cell = domain.extent.to(dtype) / M
    pos_dep = domain.wrap(pos)
    grid = _deposit(pos_dep, mass, lo, cell, M, True)
    phihat, _, vol = _periodic_phihat(grid, domain, float(cfg.G), rs, M)
    phi = torch.fft.ifftn(phihat).real / vol
    return _interp(phi[None], pos_dep, lo, cell, M, True)[:, 0]


def short_potential(pos, mass, cfg: SPHConfig, domain: Domain, rs,
                    cutoff=None, chunk: int = 1 << 24):
    """The screened, Plummer-softened pair potential at each particle [N]
    on a periodic box: -G sum_j m_j erfc(r / 2 r_s) (r^2 + eps^2)^-1/2 over
    the minimum images with 0 < r <= ``cutoff``, every pair where
    ``cutoff`` is None (as ``short_accel_dense`` sums them). With cells at
    least ``cutoff`` wide, three or more a side, each particle meets the
    particles of the 27 cells around its own, about ``chunk`` candidate
    pairs at a time; otherwise every pair, in blocks of rows."""
    G, eps2 = float(cfg.G), float(cfg.grav_eps) ** 2
    n, dtype, dev = pos.shape[0], pos.dtype, pos.device
    x = domain.wrap(pos)
    ext = domain.extent.to(dtype)

    def terms(dx, m_j):
        r2 = torch.sum(dx * dx, dim=-1)
        r = torch.sqrt(r2)
        ok = r > 0.0
        if cutoff is not None:
            ok = ok & (r <= cutoff)
        t = m_j * torch.special.erfc(r / (2.0 * rs)) * torch.rsqrt(
            r2 + eps2)
        return torch.where(ok, t, 0.0)

    nc = (torch.floor(ext / cutoff).long() if cutoff is not None
          else torch.zeros(3, dtype=torch.long))
    if int(nc.min()) < 3:
        phi = pos.new_zeros(n)
        block = max(1, chunk // max(n, 1))
        for i0 in range(0, n, block):
            dx = domain.displacement(x[i0:i0 + block, None, :] - x[None])
            phi[i0:i0 + block] = torch.sum(terms(dx, mass[None, :]), dim=-1)
        return -G * phi
    nc = nc.to(dev)
    c3 = torch.floor((x - domain.lo.to(dtype)) / ext * nc).long()
    c3 = torch.minimum(torch.clamp_min(c3, 0), nc - 1)
    flat = (c3[:, 0] * nc[1] + c3[:, 1]) * nc[2] + c3[:, 2]
    order = torch.argsort(flat)
    xs, ms, cs = x[order], mass[order], c3[order]
    count = torch.bincount(flat, minlength=int(torch.prod(nc)))
    start = torch.cumsum(count, 0) - count
    phi_s = pos.new_zeros(n)
    for off in ((a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1)
                for c in (-1, 0, 1)):
        nb = torch.remainder(cs + torch.tensor(off, device=dev), nc)
        nb = (nb[:, 0] * nc[1] + nb[:, 1]) * nc[2] + nb[:, 2]
        cnt, st = count[nb], start[nb]
        ends = torch.cumsum(cnt, 0)
        # rows [a, b) whose candidates fill about ``chunk`` pairs
        cuts = torch.searchsorted(
            ends, torch.arange(chunk, int(ends[-1]) + chunk, chunk,
                               device=dev), right=True).tolist()
        a = 0
        for b in cuts:
            if a >= n:
                break
            # a row with more than ``chunk`` candidates goes alone
            b = min(max(b, a + 1), n)
            c = cnt[a:b]
            rows = torch.repeat_interleave(
                torch.arange(a, b, device=dev), c)
            first = torch.cumsum(c, 0) - c
            j = st[rows] + (torch.arange(len(rows), device=dev)
                            - torch.repeat_interleave(first, c))
            dx = domain.displacement(xs[rows] - xs[j])
            phi_s.index_add_(0, rows, terms(dx, ms[j]))
            a = b
    phi = torch.empty_like(phi_s)
    phi[order] = phi_s
    return -G * phi


def p3m_energy(pos, mass, cfg: SPHConfig, domain: Domain, cutoff=None):
    """The P3M potential energy of a periodic box, 1/2 sum_i m_i phi_i, in
    the Ewald sum's convention (a neutralising background, the potential
    of zero mean): phi_i is the mesh's Gaussian-filtered potential
    interpolated (``mesh_potential``) plus the screened pair potential
    within ``cutoff`` (``short_potential``), minus the particle's own
    long-range potential that the mesh holds, -G m_i / (r_s sqrt(pi)),
    plus the background's short range, which the mesh drops with the
    mean, 4 pi G M r_s^2 / V. r_s is the force's: ``rs_traced`` at
    ``cutoff`` (the window's, or None for the dense engine's short range
    over every pair)."""
    G = float(cfg.G)
    rs = rs_traced(cfg, domain, pos.dtype, cutoff=cutoff)
    phi = (mesh_potential(pos, mass, cfg, domain, rs)
           + short_potential(pos, mass, cfg, domain, rs, cutoff=cutoff))
    vol = torch.prod(domain.extent.to(pos.dtype))
    phi = phi + G * mass / (rs * _SQRT_PI) + (
        4.0 * math.pi * G * rs * rs / vol) * torch.sum(mass)
    return 0.5 * torch.sum(mass * phi)
