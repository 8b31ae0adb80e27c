"""Kernels A and C of the window engine: wrappers and plain versions.

``solve_h_density`` (kernel A: Newton-h fused with the density, d rho/d h
and Balsara div/curl sums) and ``forces`` (kernel C: symmetrized pressure
force, Monaghan viscosity and du/dt) replace the Pallas TPU kernels
``sphax.physics.pallas_kernels.solve_h_density`` and ``.forces``.

Each wrapper chooses by the device of its input tensors: a CUDA tensor
launches the hand-written CUDA kernel (``sphax_torch/csrc/window_kernels.cu``,
built at first use by ``sphax_torch._build``) or raises; a CPU tensor runs
the plain torch version beside it (``*_plain``), which computes the same
contract and is what the kernels are held against on the card.

The contract per sorted row i of row-group g: the candidates are, for each
segment s, the rows k in [w_lo[g,s], w_lo[g,s] + 128 w_nact[g,s]), each
counted once (a row already inside an earlier segment's range is skipped).
Every candidate outside the true neighbour set lies beyond the kernel
support or has zero mass, so any convention that counts each row of the
union once gives the same sums up to summation order. A group whose w_nact
row is all zero writes h = h0 and zeros for every other output.
"""
from __future__ import annotations

import ctypes

import torch

from sphax_torch.configs import SPHConfig
from sphax_torch.neighbors.window import WindowData, WindowSpec
from sphax_torch.physics import kernels as K
from sphax_torch.physics import pairs

# Launches of each CUDA kernel; a wrapper adds one where it launches.
LAUNCHES = {"solve_h_density": 0, "forces": 0}


def _newton_iters(cfg: SPHConfig) -> int:
    """Newton updates before the final walk: none under h_predict (the
    lagged correction happens in wengine.stage_density)."""
    return cfg.newton_iters if cfg.adaptive_h and not cfg.h_predict else 0


def _group_active(wd: WindowData):
    return wd.w_nact.sum(dim=1) > 0                      # [n_groups]


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
    """

    def __init__(self, pos_i, m_i, pos_j, m_j, reach_i, reach_j=None):
        TB, T, dim = pos_i.shape
        nS = pos_j.shape[1]
        # distances only to the candidates that carry mass, packed to the
        # front of each group's window (stable, so in window order)
        keep = m_j > 0
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
            curl_mag = torch.sqrt(torch.sum(curl * curl, dim=-1))
            outs += (lp.sum(divv_p, shape), curl_mag)
        return outs

    own = [pos_s, mass_s, h0_s] + ([vel_s] if fuse_bals else [])
    winf = [pos_s, mass_s] + ([vel_s] if fuse_bals else [])
    outs = _tile_pass(kfn, wd, spec, own, winf, mass_axis=1)
    act = _group_active(wd).repeat_interleave(spec.group)
    h = torch.where(act, outs[0], h0_s)
    return (h,) + tuple(torch.where(act, o, 0.0) for o in outs[1:])


def forces_plain(wd: WindowData, spec: WindowSpec, pos_s, vel_s, mass_s, h_s,
                 rho_s, P_s, cs_s, om_s, bf_s, cfg: SPHConfig):
    """Returns (acc_s [Ns, D], du_s [Ns]) — pairs.force_terms summed over
    the window candidates. Always divides exactly (no fast_math)."""
    from sphax_torch.physics.wengine import _tile_pass

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
    act = _group_active(wd).repeat_interleave(spec.group)
    return torch.where(act[:, None], acc, 0.0), torch.where(act, du, 0.0)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _check_cuda(wd: WindowData, spec: WindowSpec, cfg: SPHConfig, ref,
                tensors):
    """Raise on anything the CUDA kernels do not take."""
    if cfg.dim != 3 or spec.dim != 3:
        raise NotImplementedError("the CUDA window kernels are built for "
                                  "dim=3 only")
    if spec.cwidth > 0:
        raise NotImplementedError("candidate compaction (cwidth > 0) is "
                                  "not ported yet")
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
    for name in ("w_lo", "w_nact"):
        t = getattr(wd, name)
        if (t.device != ref.device or t.dtype != torch.int32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"wd.{name} must be a contiguous int32 {shape} "
                             f"tensor on {ref.device}")


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
    """Kernel A. Returns (h, rho, drho_dh[, div_sum, curl_mag]) per sorted
    row; the last two only when cfg.need_divv and vel_s is given."""
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
    # SoA [F, Ns] candidate fields: x, y, z, m (, vx, vy, vz)
    win = torch.cat([pos_s.T, mass_s[None]]
                    + ([vel_s.T] if fuse_bals else [])).contiguous()
    h0 = h0_s.contiguous()
    outs = [torch.empty_like(h0) for _ in range(5 if fuse_bals else 3)]
    null = ctypes.c_void_p(None)
    _launch("solve_h_density", pos_s.dtype,
            _ptr(win), _ptr(h0), _ptr(wd.w_lo), _ptr(wd.w_nact),
            spec.n_sorted, spec.tile, spec.group,
            float(K.sigma(3)), float(cfg.eta) ** 3, 0.5 * float(spec.cutoff),
            _newton_iters(cfg), int(fuse_bals),
            *[_ptr(o) for o in outs],
            *([] if fuse_bals else [null, null]))
    return tuple(outs)


def forces(wd: WindowData, spec: WindowSpec, pos_s, vel_s, mass_s, h_s,
           rho_s, P_s, cs_s, om_s, bf_s, cfg: SPHConfig):
    """Kernel C. Returns (acc_s [Ns, D], du_s [Ns]); ``bf_s`` is read only
    when cfg.visc_factor_on."""
    if pos_s.device.type == "cpu":
        return forces_plain(wd, spec, pos_s, vel_s, mass_s, h_s, rho_s, P_s,
                            cs_s, om_s, bf_s, cfg)
    if pos_s.device.type != "cuda":
        raise ValueError(f"no kernel for device {pos_s.device}")
    use_bf = bool(cfg.visc_factor_on)
    tensors = dict(pos_s=pos_s, vel_s=vel_s, mass_s=mass_s, h_s=h_s,
                   rho_s=rho_s, P_s=P_s, cs_s=cs_s, om_s=om_s)
    if use_bf:
        tensors["bf_s"] = bf_s
    _check_cuda(wd, spec, cfg, pos_s, tensors)
    # per-particle hoisted fields, as the Pallas kernel ships them
    invh = 1.0 / h_s
    ci = P_s / (om_s * rho_s * rho_s)
    gc1 = float(K.sigma(3)) * invh ** 4
    gc2 = gc1 * invh
    # SoA [F, Ns]: x y z vx vy vz m h invh rho cs ci gc1 gc2 (bf)
    win = torch.cat([pos_s.T, vel_s.T]
                    + [f[None] for f in (mass_s, h_s, invh, rho_s, cs_s, ci,
                                         gc1, gc2)]
                    + ([bf_s[None]] if use_bf else [])).contiguous()
    acc = torch.empty_like(pos_s, memory_format=torch.contiguous_format)
    du = torch.empty_like(h_s, memory_format=torch.contiguous_format)
    fast = bool(cfg.fast_math) and pos_s.dtype == torch.float32
    _launch("forces", pos_s.dtype,
            _ptr(win), _ptr(wd.w_lo), _ptr(wd.w_nact),
            spec.n_sorted, spec.tile, spec.group,
            float(cfg.alpha_visc), float(cfg.beta_visc),
            float(cfg.eps_visc), int(use_bf), int(fast),
            _ptr(acc), _ptr(du))
    return acc, du
