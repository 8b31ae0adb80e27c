"""Kernels A and C of the window engine: wrappers and plain versions.

``solve_h_density`` (kernel A: Newton-h fused with the density, d rho/d h
and Balsara div/curl sums) and ``forces`` (kernel C: symmetrized pressure
force, Monaghan viscosity and du/dt, plus the fused screened P3M short-range
gravity with ``grav=(rs, eps)``) replace the Pallas TPU kernels
``sphax.physics.pallas_kernels.solve_h_density`` and ``.forces``, in 3D,
in 2D (the ``kh`` problem) and in 1D (one segment per group, no curl); the
gravity mode is 3D only.

Each wrapper chooses by the device of its input tensors: a CUDA tensor
launches the hand-written CUDA kernel (``sphax_torch/csrc/window_kernels.cu``,
built at first use by ``sphax_torch._build``) or raises; a CPU tensor runs
the plain torch version beside it (``*_plain``), which computes the same
contract and is what the kernels are held against on the card.

The contract per sorted row i of row-group g: the candidates are, for each
segment s, the rows k in [w_lo[g,s], w_lo[g,s] + 128 w_nact[g,s]), each
counted once (a row already inside an earlier segment's range is skipped).
A group's non-empty ranges start in rising order, w_lo[g,s] >= w_lo[g,s']
for s' < s: ``window.build`` makes them so and ``rungs.mask_structure``
keeps them so, and the CUDA kernels rely on it (they skip the repeated rows
by clipping each range's start at the largest end before it).
Every candidate outside the true neighbour set lies beyond the kernel
support or has zero mass, so any convention that counts each row of the
union once gives the same sums up to summation order. A group whose w_nact
row is all zero writes h = h0 and zeros for every other output.

With spec.cwidth > 0 (the compact mode, the reference's ``_compact_view``)
the candidates of group g are instead its compacted list: the disjoint runs
[c_lo[g,s], c_lo[g,s] + c_len[g,s]) in segment order, cut at cwidth rows,
with no dedup; the plain versions sum over the group's slice of
``window.gather_cands``' buffer, the CUDA kernels walk the runs in place. A
group with c_n == 0 writes h = h0 and zeros. The same pairs as the in-place
walk, in another order.

The CUDA kernels do not give every row every candidate: a warp of 32 sorted
rows first culls its group's candidates against the box of its own rows,
then walks the survivors. ``cull_plain`` states that rule in plain torch
(the same box, mass rule, reach and margins), ``cull_stats`` counts what it
keeps; the tests hold that it drops no pair inside the support.
"""
from __future__ import annotations

import ctypes
import math

import torch

from sphax_torch.configs import SPHConfig
from sphax_torch.io.metrics import span
from sphax_torch.neighbors.window import WindowData, WindowSpec
from sphax_torch.physics import kernels as K
from sphax_torch.physics import pairs

# Launches of each CUDA kernel; a wrapper adds one where it launches.
# "forces_grav" counts kernel C's gravity mode, "forces" its plain SPH mode,
# "gravity" kernel G (physics/direct_gravity.py); the "_2d" and "_1d" keys
# count the dim=2 and dim=1 instantiations of kernels A and C, the
# "_compact" keys their compact walks.
LAUNCHES = {"solve_h_density": 0, "forces": 0, "forces_grav": 0,
            "gravity": 0, "solve_h_density_2d": 0, "forces_2d": 0,
            "solve_h_density_compact": 0, "forces_compact": 0,
            "forces_grav_compact": 0, "solve_h_density_compact_2d": 0,
            "forces_compact_2d": 0, "solve_h_density_1d": 0, "forces_1d": 0,
            "solve_h_density_compact_1d": 0, "forces_compact_1d": 0}


def _newton_iters(cfg: SPHConfig) -> int:
    """Newton updates before the final walk: none under h_predict (the
    lagged correction happens in wengine.stage_density)."""
    return cfg.newton_iters if cfg.adaptive_h and not cfg.h_predict else 0


def _group_active(wd: WindowData, spec: WindowSpec):
    if spec.cwidth > 0:
        return wd.c_n > 0                                # [n_groups]
    return wd.w_nact.sum(dim=1) > 0


class _LivePairs:
    """The candidate pairs of one ``_tile_pass`` block that can contribute.

    A pair contributes only when the candidate has mass (pad rows and
    dedup-masked duplicates carry 0) and r < 2 h of a smoothing length it
    uses; every other pair's terms are exactly zero. Own rows without mass
    (pad rows) get no pairs at all: their outputs are don't-care by
    contract, and their h = 1 fill would otherwise make every candidate
    live. ``reach_i`` ([TB, T])
    and ``reach_j`` ([TB, nS], optional) bound 2 h from above, with a 1e-3
    margin so rounding in r^2 never drops a live pair; extra pairs add exact
    zeros. Evaluating the pair terms on this list instead of the dense
    [TB, T, nS] block changes only the summation order.

    Before the per-pair distances, a candidate farther from the box of the
    group's own rows with mass than every reach it could pair with is
    dropped. Its squared distance to the box is accumulated term by term as
    r^2 is, so it never exceeds any of its r^2 in floating point: the cull
    drops no live pair and keeps the live pairs' order, and the sums are
    bitwise those without it.
    """

    def __init__(self, pos_i, m_i, pos_j, m_j, reach_i, reach_j=None):
        TB, T, dim = pos_i.shape
        nS = pos_j.shape[1]
        # distances only to the kept candidates, packed to the front of
        # each group's window (stable, so in window order)
        keep = self.keep(pos_i, m_i, pos_j, m_j, reach_i, reach_j)
        L = int(keep.sum(1).max())
        cols = torch.sort((~keep).to(torch.uint8), dim=1,
                          stable=True).indices[:, :L]          # [TB, L]
        pj = torch.gather(pos_j, 1, cols[..., None].expand(TB, L, dim))
        r2 = torch.zeros((TB, T, L), dtype=pos_i.dtype, device=pos_i.device)
        for d in range(dim):
            dxd = pos_i[:, :, None, d] - pj[:, None, :, d]
            r2 += dxd * dxd
        reach = reach_i[..., None]
        if reach_j is not None:
            reach = torch.maximum(reach,
                                  torch.gather(reach_j, 1, cols)[:, None, :])
        live = ((r2 < (1.001 * reach) ** 2) & (m_i > 0)[..., None]
                & torch.gather(keep, 1, cols)[:, None, :])
        b, i, k = torch.nonzero(live, as_tuple=True)
        self.rows = TB * T
        self.row = b * T + i                 # flat own row of each pair
        self.col = b * nS + cols[b, k]       # flat window entry of each pair
        self.dx = (pos_i.reshape(-1, dim)[self.row]
                   - pos_j.reshape(-1, dim)[self.col])
        self.r = torch.sqrt(torch.sum(self.dx * self.dx, dim=-1))

    @staticmethod
    def keep(pos_i, m_i, pos_j, m_j, reach_i, reach_j):
        """[TB, nS] bool: the candidates that carry mass and lie within
        1.001 of a reach they could pair with of the box of the group's own
        rows with mass (the cull of the class docstring)."""
        dim = pos_i.shape[-1]
        has = (m_i > 0)[..., None]
        inf = float("inf")
        lo = torch.where(has, pos_i, inf).amin(1)[:, None]    # [TB, 1, D]
        hi = torch.where(has, pos_i, -inf).amax(1)[:, None]
        gap = torch.clamp_min(torch.maximum(lo - pos_j, pos_j - hi), 0.0)
        g2 = torch.zeros(pos_j.shape[:2], dtype=pos_i.dtype,
                         device=pos_i.device)
        for d in range(dim):
            g2 += gap[..., d] * gap[..., d]
        reach_c = torch.where(has[..., 0], reach_i, 0.0).amax(1)[:, None]
        if reach_j is not None:
            reach_c = torch.maximum(reach_c, reach_j)
        return (m_j > 0) & (g2 < (1.001 * reach_c) ** 2)

    def own(self, f):
        return f.reshape((self.rows,) + f.shape[2:])[self.row]

    def win(self, f):
        return f.reshape((-1,) + f.shape[2:])[self.col]

    def sum(self, vals, shape):
        """Sum pair values into their own rows -> ``shape``."""
        out = vals.new_zeros((self.rows,) + vals.shape[1:])
        return out.index_add_(0, self.row, vals).reshape(
            shape + vals.shape[1:])


# ---------------------------------------------------------------------------
# the warp cull of the CUDA kernels, as plain torch
# ---------------------------------------------------------------------------

# The margins of csrc/window_kernels.cu's Margin: 2 * 1.001, its square,
# and 1.001^2 on the squared gravity cutoff.
CULL_REACH, CULL_REACH2_J, CULL_RCUT2 = 2.002, 4.008004, 1.002001


def candidate_table(wd: WindowData, spec: WindowSpec, groups):
    """The candidate rows of the row-groups ``groups`` in ``_tile_pass``'s
    window layout: (idx [n, W] int64 sorted rows, valid [n, W] bool). In
    place W = n_seg * wseg, segment s at columns [s wseg, (s + 1) wseg),
    valid inside the segment's 128 w_nact rows and outside the earlier
    segments' (a row's first occurrence in the kernels' walk; ``_tile_pass``
    dedups on the static width wseg instead, so a row the two count once
    each may sit at different columns); compact W = cwidth,
    ``window.compact_index``, valid below c_n. The CUDA kernels visit the
    valid entries, in this order."""
    from sphax_torch.neighbors import window as win

    if spec.cwidth > 0:
        idx = win.compact_index(wd, spec, groups).long()
        ar = torch.arange(spec.cwidth, device=idx.device)
        return idx, ar < torch.clamp_max(wd.c_n[groups], spec.cwidth)[:, None]
    S, n_seg = spec.wseg, spec.n_seg
    ar = torch.arange(S, dtype=torch.int64, device=wd.w_lo.device)
    lo = wd.w_lo[groups].long()                            # [n, n_seg]
    hi = lo + 128 * wd.w_nact[groups].long()
    k = lo[..., None] + ar                                 # [n, n_seg, S]
    valid = k < hi[..., None]
    for s in range(1, n_seg):
        for sp in range(s):
            valid[:, s] &= ~((k[:, s] >= lo[:, sp, None])
                             & (k[:, s] < hi[:, sp, None]))
    return k.reshape(-1, n_seg * S), valid.reshape(-1, n_seg * S)


def _cull_blocks(wd: WindowData, spec: WindowSpec, pos_s, mass_s, h_s,
                 pair_h: bool, rcut):
    """Yield (groups, idx, valid, keep [n, warps, W]) over blocks of the
    row-groups with candidates; see ``cull_plain``."""
    T = spec.group
    nw = T // 32
    width = spec.cwidth if spec.cwidth > 0 else spec.n_seg * spec.wseg
    TB = max(1, 4_000_000 // (width * nw * spec.dim))
    gids = torch.nonzero(_group_active(wd, spec)).reshape(-1)
    ar_t = torch.arange(T, dtype=torch.int64, device=gids.device)
    inf = float("inf")
    for b0 in range(0, gids.numel(), TB):
        g = gids[b0:b0 + TB]
        idx, valid = candidate_table(wd, spec, g)
        rows = (g[:, None] * T + ar_t).reshape(-1, nw, 32)
        has = (mass_s[rows] > 0)[..., None]
        x = pos_s[rows]                                    # [n, nw, 32, D]
        lo = torch.where(has, x, inf).amin(2)[:, :, None]  # [n, nw, 1, D]
        hi = torch.where(has, x, -inf).amax(2)[:, :, None]
        h_max = torch.where(has[..., 0], h_s[rows], 0.0).amax(2)
        pj = pos_s[idx][:, None]                           # [n, 1, W, D]
        gap = torch.clamp_min(torch.maximum(lo - pj, pj - hi), 0.0)
        g2 = torch.sum(gap * gap, dim=-1)                  # [n, nw, W]
        keep = g2 < ((CULL_REACH * h_max) ** 2)[..., None]
        if pair_h:
            inv_hj = (1.0 / h_s[idx])[:, None]
            keep |= g2 * inv_hj * inv_hj < CULL_REACH2_J
        if rcut is not None:
            keep |= g2 <= float(rcut) ** 2 * CULL_RCUT2
        keep &= (valid & (mass_s[idx] > 0))[:, None]
        yield g, idx, valid, keep


def cull_plain(wd: WindowData, spec: WindowSpec, pos_s, mass_s, h_s,
               pair_h: bool = False, rcut=None):
    """Which candidates each warp of the CUDA kernels stages for its walk.

    A warp is 32 consecutive sorted rows of one row-group. It takes the
    axis-aligned box of its rows that carry mass and the largest of their
    ``h_s``, and keeps a candidate row j of its group's table when j
    carries mass and its distance to the box is below the reach: 2 h_max
    (kernel A, at the h of the walk), with ``pair_h`` 2 max(h_max, h_j)
    (kernel C), with ``rcut`` at least that cutoff (C's gravity mode); all
    1e-3 wider. A warp without a row that carries mass keeps nothing.

    Returns (groups [G], idx [G, W], valid [G, W], keep [G, group // 32,
    W]) over the row-groups with candidates, in ``candidate_table``'s
    layout. For the tests and small inputs: it holds every group at once.
    """
    parts = list(_cull_blocks(wd, spec, pos_s, mass_s, h_s, pair_h, rcut))
    return tuple(torch.cat([p[k] for p in parts]) for k in range(4))


def cull_stats(wd: WindowData, spec: WindowSpec, pos_s, mass_s, h_s,
               pair_h: bool = False, rcut=None):
    """(candidates, survivors) per real row: the mean, over the rows that
    are real particles, of the valid entries of their group's candidate
    table and of the entries their warp stages (``cull_plain``), one block
    of groups at a time."""
    T = spec.group
    ar_t = torch.arange(T, dtype=torch.int64, device=pos_s.device)
    cand = surv = real = 0
    for g, idx, valid, keep in _cull_blocks(wd, spec, pos_s, mass_s, h_s,
                                            pair_h, rcut):
        rows = (g[:, None] * T + ar_t).reshape(-1, T // 32, 32)
        n_real = wd.is_real[rows].sum(2)                   # [n, nw]
        real += int(n_real.sum())
        cand += int((valid.sum(1)[:, None] * n_real).sum())
        surv += int((keep.sum(2) * n_real).sum())
    return cand / max(real, 1), surv / max(real, 1)


# ---------------------------------------------------------------------------
# plain torch versions (CPU path, and the reference on the card)
# ---------------------------------------------------------------------------


def solve_h_density_plain(wd: WindowData, spec: WindowSpec, pos_s, mass_s,
                          h0_s, cfg: SPHConfig, vel_s=None):
    """Returns (h, rho, drho_dh[, div_sum, curl_mag]) per sorted row;
    ``div_sum`` and ``curl_mag`` are the raw sums that stage_density
    divides by rho."""
    from sphax_torch.physics.wengine import _tile_pass

    dim = cfg.dim
    fuse_bals = bool(cfg.need_divv) and vel_s is not None
    iters = _newton_iters(cfg)
    eta_d = float(cfg.eta) ** dim
    hcap = 0.5 * float(spec.cutoff)

    def newton_update(h, rho, drdh, m_safe):
        # kernel A's thresholds (1e-30)
        rho = torch.clamp_min(rho, 1e-30)
        rho_h = m_safe * eta_d / h ** dim
        phi = rho - rho_h
        dphi = drdh + dim * rho_h / h
        dphi = torch.where(torch.abs(dphi) < 1e-30, -1e-30, dphi)
        dh = torch.minimum(torch.maximum(-phi / dphi, -0.5 * h), 0.5 * h)
        return torch.clamp_max(h + dh, hcap)

    def kfn(own, winf):
        pos_i, m_i, h = own[:3]
        pos_j, m_j = winf[:2]
        shape = tuple(h.shape)
        m_safe = torch.clamp_min(m_i, 1e-30)
        # every Newton h stays <= max(h0, hcap)
        lp = _LivePairs(pos_i, m_i, pos_j, m_j,
                        2.0 * torch.clamp_min(h, hcap))
        mj = lp.win(m_j)

        def walk(h):
            w, dwdh = pairs.density_terms(lp.r, lp.own(h), mj, dim)
            return lp.sum(w, shape), lp.sum(dwdh, shape)

        for _ in range(iters):
            h = newton_update(h, *walk(h), m_safe)
        rho, drdh = walk(h)
        outs = (h, rho, drdh)
        if fuse_bals:
            dv = lp.own(own[3]) - lp.win(winf[2])
            divv_p, curl_p = pairs.balsara_terms(lp.dx, lp.r, dv, lp.own(h),
                                                 mj, dim)
            curl = lp.sum(curl_p, shape)
            # a vector in 3D, one scalar component in 2D, zero in 1D
            curl_mag = (torch.sqrt(torch.sum(curl * curl, dim=-1))
                        if dim == 3 else torch.abs(curl))
            outs += (lp.sum(divv_p, shape), curl_mag)
        return outs

    own = [pos_s, mass_s, h0_s] + ([vel_s] if fuse_bals else [])
    winf = [pos_s, mass_s] + ([vel_s] if fuse_bals else [])
    outs = _tile_pass(kfn, wd, spec, own, winf, mass_axis=1)
    act = _group_active(wd, spec).repeat_interleave(spec.group)
    h = torch.where(act, outs[0], h0_s)
    return (h,) + tuple(torch.where(act, o, 0.0) for o in outs[1:])


def forces_plain(wd: WindowData, spec: WindowSpec, pos_s, vel_s, mass_s, h_s,
                 rho_s, P_s, cs_s, om_s, bf_s, cfg: SPHConfig, grav=None):
    """Returns (acc_s [Ns, D], du_s [Ns]) — pairs.force_terms summed over
    the window candidates, plus ``wengine.gravity_short_pass`` with
    ``grav=(rs, eps)``. Always divides exactly (no fast_math)."""
    from sphax_torch.physics.wengine import _tile_pass, gravity_short_pass

    use_bf = bool(cfg.visc_factor_on)

    def kfn(own, winf):
        pos_i, vel_i, m_i = own[:3]
        pos_j, vel_j, m_j = winf[:3]
        shape = tuple(own[3].shape)
        lp = _LivePairs(pos_i, m_i, pos_j, m_j, 2.0 * own[3], 2.0 * winf[3])
        dv = lp.own(vel_i) - lp.win(vel_j)
        # own: h rho P cs om (bf); window: h rho P cs om (bf)
        oi = [lp.own(f) for f in own[3:]]
        wj = [lp.win(f) for f in winf[3:]]
        fcoef, du = pairs.force_terms(
            lp.dx, lp.r, dv, oi[0], wj[0], oi[1], wj[1], oi[2], wj[2],
            oi[3], wj[3], oi[4], wj[4], lp.win(m_j), cfg,
            bf_i=oi[5] if use_bf else None, bf_j=wj[5] if use_bf else None)
        return (-lp.sum(fcoef[:, None] * lp.dx, shape), lp.sum(du, shape))

    own = [pos_s, vel_s, mass_s, h_s, rho_s, P_s, cs_s, om_s]
    winf = [pos_s, vel_s, mass_s, h_s, rho_s, P_s, cs_s, om_s]
    if use_bf:
        own.append(bf_s)
        winf.append(bf_s)
    acc, du = _tile_pass(kfn, wd, spec, own, winf, mass_axis=2)
    if grav is not None:
        acc = acc + gravity_short_pass(wd, spec, pos_s, mass_s, cfg, *grav)
    act = _group_active(wd, spec).repeat_interleave(spec.group)
    return torch.where(act[:, None], acc, 0.0), torch.where(act, du, 0.0)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _check_cuda(wd: WindowData, spec: WindowSpec, cfg: SPHConfig, ref,
                tensors, grav=False):
    """Raise on anything the CUDA kernels do not take."""
    if cfg.dim != spec.dim or cfg.dim not in (1, 2, 3):
        raise NotImplementedError(f"the CUDA window kernels are built for "
                                  f"dim 1, 2 and 3 (cfg.dim={cfg.dim}, "
                                  f"spec.dim={spec.dim})")
    if grav and cfg.dim != 3:
        raise NotImplementedError("kernel C's gravity mode is 3D only, as "
                                  "the P3M mesh is")
    if ref.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"unsupported dtype {ref.dtype}")
    if spec.group % 32 or spec.tile > 1024:
        raise ValueError(f"row-group of {spec.group} rows (tile "
                         f"{spec.tile}) must be a multiple of 32 rows in a "
                         "tile of at most 1024")
    Ns = spec.n_sorted
    for name, t in tensors.items():
        if t.device != ref.device:
            raise ValueError(f"{name} is on {t.device}, not {ref.device}")
        if t.dtype != ref.dtype:
            raise TypeError(f"{name} is {t.dtype}, not {ref.dtype}")
        if t.shape[0] != Ns:
            raise ValueError(f"{name} has {t.shape[0]} rows, not {Ns}")
    shape = (spec.n_groups, spec.n_seg)
    for name in _tables(spec):
        t = getattr(wd, name)
        if (t is None or t.device != ref.device or t.dtype != torch.int32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"wd.{name} must be a contiguous int32 {shape} "
                             f"tensor on {ref.device}")


def _tables(spec: WindowSpec):
    """The group tables a walk reads: the compacted runs in compact mode,
    the in-place windows otherwise."""
    return ("c_lo", "c_len") if spec.cwidth > 0 else ("w_lo", "w_nact")


def _walk(base: str, wd: WindowData, spec: WindowSpec, dim: int):
    """The walk's entry point and launch key (``base``, ``base_2d`` in 2D,
    ``base_1d`` in 1D, ``base_compact[_2d, _1d]`` for the compact walk),
    its two group tables, and its size arguments: n_sorted, tile, group,
    and cwidth when compact."""
    compact = spec.cwidth > 0
    name = _kernel_name(f"{base}_compact" if compact else base, dim)
    tabs = [_ptr(getattr(wd, t)) for t in _tables(spec)]
    size = [spec.n_sorted, spec.tile, spec.group] + (
        [spec.cwidth] if compact else [])
    return name, tabs, size


def _kernel_name(base: str, dim: int) -> str:
    """The C entry point and launch key: ``base`` in 3D, ``base_2d`` in 2D,
    ``base_1d`` in 1D."""
    return base if dim == 3 else f"{base}_{dim}d"


def _launch(fn_name, dtype, *args):
    from sphax_torch import _build

    lib = _build.load()
    suffix = "f32" if dtype == torch.float32 else "f64"
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    err = getattr(lib, f"sphax_{fn_name}_{suffix}")(*args, stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {fn_name} failed to launch: "
                           f"{_build.error_string(err)}")
    LAUNCHES[fn_name] += 1


def solve_h_density(wd: WindowData, spec: WindowSpec, pos_s, mass_s, h0_s,
                    cfg: SPHConfig, vel_s=None):
    """Kernel A, in 3D, 2D or 1D, in place or (spec.cwidth > 0) compact.
    Returns (h, rho, drho_dh[, div_sum, curl_mag]) per sorted row; the last
    two only when cfg.need_divv and vel_s is given."""
    with span("sphax_torch.kernel_a"):
        if pos_s.device.type == "cpu":
            return solve_h_density_plain(wd, spec, pos_s, mass_s, h0_s, cfg,
                                         vel_s=vel_s)
        if pos_s.device.type != "cuda":
            raise ValueError(f"no kernel for device {pos_s.device}")
        fuse_bals = bool(cfg.need_divv) and vel_s is not None
        tensors = dict(pos_s=pos_s, mass_s=mass_s, h0_s=h0_s)
        if fuse_bals:
            tensors["vel_s"] = vel_s
        _check_cuda(wd, spec, cfg, pos_s, tensors)
        dim = cfg.dim
        # SoA [F, Ns] candidate fields: the dim positions, m (, dim
        # velocities)
        win = torch.cat([pos_s.T, mass_s[None]]
                        + ([vel_s.T] if fuse_bals else [])).contiguous()
        h0 = h0_s.contiguous()
        outs = [torch.empty_like(h0) for _ in range(5 if fuse_bals else 3)]
        null = ctypes.c_void_p(None)
        name, tabs, size = _walk("solve_h_density", wd, spec, dim)
        _launch(name, pos_s.dtype, _ptr(win), _ptr(h0), *tabs, *size,
                float(K.sigma(dim)), float(cfg.eta) ** dim,
                0.5 * float(spec.cutoff),
                _newton_iters(cfg), int(fuse_bals),
                *[_ptr(o) for o in outs],
                *([] if fuse_bals else [null, null]))
        return tuple(outs)


def forces(wd: WindowData, spec: WindowSpec, pos_s, vel_s, mass_s, h_s,
           rho_s, P_s, cs_s, om_s, bf_s, cfg: SPHConfig, grav=None):
    """Kernel C, in 3D, 2D or 1D, in place or (spec.cwidth > 0) compact.
    Returns (acc_s [Ns, D], du_s [Ns]); ``bf_s``
    is read only when cfg.visc_factor_on. ``grav=(rs, eps)`` (3D only) adds
    the screened P3M short range over the same candidates, hard-cut at
    spec.cutoff; ``rs`` is a 0-d tensor on the inputs' device, so no step
    waits on the host."""
    with span("sphax_torch.kernel_c"):
        if pos_s.device.type == "cpu":
            return forces_plain(wd, spec, pos_s, vel_s, mass_s, h_s, rho_s,
                                P_s, cs_s, om_s, bf_s, cfg, grav=grav)
        if pos_s.device.type != "cuda":
            raise ValueError(f"no kernel for device {pos_s.device}")
        use_bf = bool(cfg.visc_factor_on)
        tensors = dict(pos_s=pos_s, vel_s=vel_s, mass_s=mass_s, h_s=h_s,
                       rho_s=rho_s, P_s=P_s, cs_s=cs_s, om_s=om_s)
        if use_bf:
            tensors["bf_s"] = bf_s
        _check_cuda(wd, spec, cfg, pos_s, tensors, grav=grav is not None)
        dim = cfg.dim
        # per-particle hoisted fields, as the Pallas kernel ships them
        invh = 1.0 / h_s
        ci = P_s / (om_s * rho_s * rho_s)
        gc1 = float(K.sigma(dim)) * invh ** (dim + 1)
        gc2 = gc1 * invh
        # SoA [F, Ns]: the dim positions and velocities, then
        # m h invh rho cs ci gc1 gc2 (bf)
        win = torch.cat([pos_s.T, vel_s.T]
                        + [f[None] for f in (mass_s, h_s, invh, rho_s, cs_s,
                                             ci, gc1, gc2)]
                        + ([bf_s[None]] if use_bf else [])).contiguous()
        acc = torch.empty_like(pos_s, memory_format=torch.contiguous_format)
        du = torch.empty_like(h_s, memory_format=torch.contiguous_format)
        fast = bool(cfg.fast_math) and pos_s.dtype == torch.float32
        name, tabs, size = _walk("forces" if grav is None else "forces_grav",
                                 wd, spec, dim)
        args = [_ptr(win), *tabs, *size, float(cfg.alpha_visc),
                float(cfg.beta_visc), float(cfg.eps_visc), int(use_bf),
                int(fast)]
        if grav is None:
            _launch(name, pos_s.dtype, *args, _ptr(acc), _ptr(du))
            return acc, du
        rs, eps = grav
        if (not isinstance(rs, torch.Tensor) or rs.device != pos_s.device
                or rs.numel() != 1):
            raise ValueError(f"grav rs must be a one-element tensor on "
                             f"{pos_s.device}")
        rs = rs.reshape(()).to(pos_s.dtype)
        e = torch.full_like(rs, float(eps))
        # the per-pair form needs only these: x = r * sc0,
        # screen = erfc(x) + r * sc1 * exp(-x^2), soft = rsqrt(r^2 + sc2)^3
        gsc = torch.stack([0.5 / rs, 1.0 / (rs * math.sqrt(math.pi)), e * e])
        _launch(name, pos_s.dtype, *args, _ptr(gsc), float(cfg.G),
                float(spec.cutoff) ** 2, _ptr(acc), _ptr(du))
        return acc, du
