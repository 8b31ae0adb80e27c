"""Sorted-order CIC mesh deposit and interpolation (torch twin of
``sphax.physics.pm_sorted``).

The window structure's sort is row-major over its cell grid, so G
consecutive sorted rows lie in a small transverse brick of mesh nodes
(Bx x By, the whole z axis). Per "program" of G rows the deposit is ONE
[Bx By, G] @ [G, M] product of separable one-hot CIC weight matrices (the
z axis rides the product's columns, so both z nodes of every row land in
one pass), and the interpolation is its transpose: a brick read, the
mirrored product and a z-weighted row sum. Rows outside their program's
brick (pencil-row crossings at the y wrap, far drifters, uneven
occupancy) go through the scatter mesh of ``pm`` (``_deposit`` and
``_interp``), packed to a fixed capacity ``plan.cap``; ``dropped`` counts
the rows past it and must be zero.

The JAX version replaced the scatter of ``pm.mesh_accel`` by this on the
TPU, where a scatter serializes. On a CUDA card ``index_add_`` is the
cheaper mesh (``pm.mesh_accel``), and every engine runs that one; this
path is a library function (``pm.mesh_accel_sorted``), and
``fallback_stats`` is what ``wengine.mesh_fallback_count`` reports. Here
the programs run in batches: one batched product per batch, and the
bricks accumulate into the padded grid with one ``index_add_`` over their
(x, y) node rows (atomics on a card, so its sums are not bitwise
deterministic there, as ``pm._deposit``'s are not). The products run in
true fp32 (or fp64): the process's TF32 setting is switched off around
them, since CIC weights feed force errors.

Periodic boxes never wrap node indices inside a program: deposits land in
a +Bx/+By margin that is folded back after the programs, and the
interpolation reads from a wrap-padded grid; the z axis wraps in-row.
Open boxes use ``pm._cic_weights``' clip-first node convention verbatim.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from sphax_torch.core.state import Domain
from sphax_torch.neighbors.window import WindowSpec, _pack_offset
from sphax_torch.physics.pm import _deposit, _interp

# bytes of one batch's one-hot weights: programs run in batches this big
_BATCH_BYTES = 1 << 28


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """Geometry of the sorted-mesh programs."""

    G: int    # sorted rows per program (a multiple of 128)
    Bx: int   # brick nodes along axis 0 (program x span + CIC + drift)
    By: int   # brick nodes along axis 1
    cap: int  # packed-fallback capacity (rows outside their brick)


def plan_mesh(spec: WindowSpec, M: int, node_per_cell=None) -> MeshPlan:
    """Host-side plan: brick extents from the window-cell -> mesh-cell
    ratio and the estimated pencil occupancy. G halves (to 256 at least)
    until a program's expected transverse span fits a brick of <= 32
    nodes.

    ``node_per_cell`` ((rx, ry), optional): mesh nodes per window cell on
    the two transverse axes. The default assumes the window box is the
    mesh box; a rank of a distributed run builds its windows over a local
    bin box and passes the scaled ratios."""
    res = spec.res
    if len(res) != 3:
        raise ValueError("sorted mesh path is 3D-only (like pm._deposit)")
    Ns = spec.n_sorted
    if node_per_cell is not None:
        rx, ry = node_per_cell
    else:
        rx = M / res[0]
        ry = M / res[1]
    occ = max(Ns / (res[0] * res[1]), 1.0)  # sorted rows per pencil

    def by_for(g):
        # pencils spanned by g rows (+1.5 boundary/drift slack), in nodes,
        # +3 for the CIC right node and floor/offset rounding
        return int(np.ceil((g / occ + 1.5) * ry)) + 3

    G = 2048
    while G > 256 and by_for(G) > 32:
        G //= 2
    Bx = min(int(np.ceil(rx)) + 3, M + 1)
    By = min(by_for(G), M + 1)
    # the fallback's cost follows its capacity; Ns/32 holds about 10x the
    # uniform lattice's fallback share, and overflow is counted
    cap = min(int(np.ceil(max(8192, Ns // 32) / 128.0) * 128), Ns)
    return MeshPlan(G=G, Bx=Bx, By=By, cap=cap)


@contextlib.contextmanager
def _full_precision():
    """fp32 matrix products in full fp32 (no TF32) inside the block. The
    cuBLAS flag is read and restored as it stands: asking the matmul
    precision after a caller set this flag raises in recent torch."""
    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_tf32
    matmul.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32 = saved


def _geometry(pos_s, maskvec, domain: Domain, M: int, periodic: bool,
              plan: MeshPlan):
    """Per-program geometry: CIC nodes and fractions, masked-min brick
    offsets and the in-brick validity. The node and fraction conventions
    are ``pm._cic_weights``' exactly (the fallback IS ``_deposit`` and
    ``_interp``, so both paths agree on where a row deposits)."""
    Ns = pos_s.shape[0]
    dtype = pos_s.dtype
    lo = domain.lo.to(dtype)
    cellm = domain.extent.to(dtype) / M
    u = (pos_s - lo) / cellm
    if periodic:
        u = torch.remainder(u, M)
        i0 = torch.floor(u).to(torch.int64)
        frac = u - i0
        # _cic_weights wraps i0 to 0 when u rounds to exactly M (frac 0
        # there, so node M gets no weight); clamping to M-1 keeps brick
        # locality and deposits the same zero at the folded node
        i0 = torch.clamp(i0, 0, M - 1)
    else:
        i0 = torch.clamp(torch.floor(u).to(torch.int64), 0, M - 2)
        frac = torch.clamp(u - i0, 0.0, 1.0)
    G = plan.G
    npr = -(-Ns // G)
    pad = npr * G - Ns

    def padG(a):
        return torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))])

    i0p = padG(i0).reshape(npr, G, 3)
    fp = padG(frac).reshape(npr, G, 3)
    mp = padG(maskvec).reshape(npr, G)
    ox = torch.where(mp, i0p[:, :, 0], M).amin(dim=1)
    oy = torch.where(mp, i0p[:, :, 1], M).amin(dim=1)
    xl = i0p[:, :, 0] - ox[:, None]
    yl = i0p[:, :, 1] - oy[:, None]
    valid = ((xl >= 0) & (xl <= plan.Bx - 2)
             & (yl >= 0) & (yl <= plan.By - 2))
    return dict(npr=npr, i0p=i0p, fp=fp, mp=mp, ox=ox, oy=oy, xl=xl, yl=yl,
                valid=valid, lo=lo, cellm=cellm)


def _onehot_xy(xl_g, yl_g, fx, fy, Bx: int, By: int):
    """Separable CIC weights -> [P, Bx*By, G] one-hot brick matrices of a
    batch of P programs."""
    xr = torch.arange(Bx, device=xl_g.device)[None, :, None]
    yr = torch.arange(By, device=xl_g.device)[None, :, None]
    zero = fx.new_zeros(())
    xl, yl = xl_g[:, None, :], yl_g[:, None, :]
    fx, fy = fx[:, None, :], fy[:, None, :]
    Wx = (torch.where(xr == xl, 1.0 - fx, zero)
          + torch.where(xr == xl + 1, fx, zero))          # [P, Bx, G]
    Wy = (torch.where(yr == yl, 1.0 - fy, zero)
          + torch.where(yr == yl + 1, fy, zero))          # [P, By, G]
    return (Wx[:, :, None, :] * Wy[:, None, :, :]).reshape(
        xl_g.shape[0], Bx * By, -1)


def _onehot_z(iz, fz, M: int, periodic: bool, wlo, whi):
    """z-node weights [P, G, M]: both CIC z nodes share the row, so the
    periodic z wrap costs one modulo, not padding."""
    ziota = torch.arange(M, device=iz.device)
    iz1 = torch.remainder(iz + 1, M) if periodic else iz + 1
    zero = wlo.new_zeros(())
    return (torch.where(ziota == iz[..., None], wlo[..., None], zero)
            + torch.where(ziota == iz1[..., None], whi[..., None], zero))


def _batches(plan: MeshPlan, npr: int, M: int, itemsize: int):
    """Program ranges [p0, p1) of about _BATCH_BYTES of weights each."""
    per = plan.G * (plan.Bx * plan.By + 4 * M) * itemsize
    step = max(1, _BATCH_BYTES // per)
    return [(p, min(p + step, npr)) for p in range(0, npr, step)]


def fallback_stats(pos_s, maskvec, domain: Domain, M: int, periodic: bool,
                   plan: MeshPlan):
    """(rows through the packed fallback, rows DROPPED past plan.cap) of
    the masked rows: the counters inside deposit/interp without the
    programs. ``dropped`` must be zero; a large fallback share says the
    plan's brick no longer fits the particle distribution."""
    Ns = pos_s.shape[0]
    geo = _geometry(pos_s, maskvec, domain, M, periodic, plan)
    n_fb = torch.sum(maskvec & ~geo["valid"].reshape(-1)[:Ns])
    return n_fb, torch.clamp_min(n_fb - plan.cap, 0)


def deposit_sorted(pos_s, w, domain: Domain, M: int, periodic: bool,
                   plan: MeshPlan):
    """CIC deposit of sorted rows with weights ``w`` -> ([M, M, M],
    dropped). ``w`` must already be zero on ghost and pad rows (they alias
    owners)."""
    Ns = pos_s.shape[0]
    dtype = pos_s.dtype
    Bx, By, G = plan.Bx, plan.By, plan.G
    geo = _geometry(pos_s, w > 0, domain, M, periodic, plan)
    npr = geo["npr"]
    wv = torch.where(geo["valid"],
                     torch.cat([w, w.new_zeros(npr * G - Ns)]).reshape(
                         npr, G), 0.0)
    i0p, fp = geo["i0p"], geo["fp"]
    grid = pos_s.new_zeros(((M + Bx) * (M + By), M))
    bx = torch.arange(Bx, device=pos_s.device)
    by = torch.arange(By, device=pos_s.device)
    with _full_precision():
        for p0, p1 in _batches(plan, npr, M, pos_s.element_size()):
            W = _onehot_xy(geo["xl"][p0:p1], geo["yl"][p0:p1],
                           fp[p0:p1, :, 0], fp[p0:p1, :, 1], Bx, By)
            fz, wg = fp[p0:p1, :, 2], wv[p0:p1]
            Z = _onehot_z(i0p[p0:p1, :, 2], fz, M, periodic,
                          (1.0 - fz) * wg, fz * wg)
            brick = torch.bmm(W, Z)                       # [P, BxBy, M]
            rows = ((geo["ox"][p0:p1, None, None] + bx[None, :, None])
                    * (M + By)
                    + geo["oy"][p0:p1, None, None] + by[None, None, :])
            grid.index_add_(0, rows.reshape(-1), brick.reshape(-1, M))
    grid = grid.reshape(M + Bx, M + By, M)
    if periodic:
        grid[0:Bx] += grid[M:M + Bx].clone()
        grid[:, 0:By] += grid[:, M:M + By].clone()
    out = grid[:M, :M, :]

    # the exact packed fallback for rows outside their program's brick
    fb = (w > 0) & ~geo["valid"].reshape(-1)[:Ns]
    idx, dropped = _pack_offset(fb, torch.arange(Ns, device=w.device),
                                plan.cap, Ns)
    take = torch.clamp_max(idx, Ns - 1).long()
    wf = torch.where(idx < Ns, w[take], 0.0)
    out = out + _deposit(pos_s[take], wf, geo["lo"], geo["cellm"], M,
                         periodic)
    return out, dropped


def interp_sorted(grids, pos_s, realmask, domain: Domain, M: int,
                  periodic: bool, plan: MeshPlan):
    """CIC interpolation of [3, M, M, M] grids -> ([Ns, 3], dropped). Only
    rows with ``realmask`` are guaranteed values (ghost and pad rows'
    outputs are don't-care, as the window kernels' are)."""
    Ns = pos_s.shape[0]
    Bx, By, G = plan.Bx, plan.By, plan.G
    geo = _geometry(pos_s, realmask, domain, M, periodic, plan)
    npr = geo["npr"]
    if periodic:
        # wrap padding (jnp.pad's mode="wrap", which repeats the grid when
        # a brick is wider than it)
        wx = torch.remainder(torch.arange(M + Bx, device=grids.device), M)
        wy = torch.remainder(torch.arange(M + By, device=grids.device), M)
        padded = grids[:, wx][:, :, wy]
    else:
        padded = torch.nn.functional.pad(grids, (0, 0, 0, By, 0, Bx))
    i0p, fp = geo["i0p"], geo["fp"]
    bx = torch.arange(Bx, device=pos_s.device)
    by = torch.arange(By, device=pos_s.device)
    outs = []
    with _full_precision():
        for p0, p1 in _batches(plan, npr, M, pos_s.element_size()):
            W = _onehot_xy(geo["xl"][p0:p1], geo["yl"][p0:p1],
                           fp[p0:p1, :, 0], fp[p0:p1, :, 1], Bx, By)
            fz = fp[p0:p1, :, 2]
            Znw = _onehot_z(i0p[p0:p1, :, 2], fz, M, periodic, 1.0 - fz, fz)
            ix = geo["ox"][p0:p1, None] + bx[None, :]          # [P, Bx]
            iy = geo["oy"][p0:p1, None] + by[None, :]          # [P, By]
            reg = padded[:, ix[:, :, None], iy[:, None, :], :]  # [3,P,Bx,By,M]
            regt = reg.permute(1, 2, 3, 0, 4).reshape(p1 - p0, Bx * By,
                                                      3 * M)
            B = torch.bmm(W.transpose(1, 2), regt).reshape(
                p1 - p0, G, 3, M)
            outs.append(torch.sum(B * Znw[:, :, None, :], dim=3))
    acc = torch.cat(outs).reshape(-1, 3)[:Ns]

    fb = realmask & ~geo["valid"].reshape(-1)[:Ns]
    idx, dropped = _pack_offset(fb, torch.arange(Ns, device=pos_s.device),
                                plan.cap, Ns)
    take = torch.clamp_max(idx, Ns - 1).long()
    vals = _interp(list(grids), pos_s[take], geo["lo"], geo["cellm"], M,
                   periodic)
    # rows past the capacity (index Ns) land on a row that is cut off
    acc = torch.cat([acc, acc.new_zeros(1, 3)])
    acc[idx.long()] = vals
    return acc[:Ns], dropped
