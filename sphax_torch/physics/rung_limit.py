"""Saitoh & Makino's timestep limiter's pair pass: wrappers and plain
versions.

The limiter (``integrate.rungs``, ``limiter=A`` with A = 2^a) keeps every
particle's step within a factor A of its neighbours'. Two passes over the
window structure's candidates compute what it needs:

``tick``  one launch a tick, over the row-groups that hold a closing row.
          Each closer i takes m_i, the lowest current rung among its
          neighbours; its new rung is its wanted rung ``r_des`` capped at
          m_i + a, aligned as ``rungs.close_rungs`` aligns it. It then
          offers that rung plus a to each neighbour j that does not close
          and sleeps above it: j's wake target is the least, over such
          closers, of max(r_i' + a, the least rung whose step from j's
          opening ends after this tick), kept where it lies below j's rung.
          Returns (m [n], target [n], the closers the cap lowered): m is
          n_rungs - 1 off the closers, target the rungs with each wake-up
          landed.
``sync``  one pass at a span's sync point over every row: rung = min(rung,
          m + a). ``sync_passes`` says how many reach the fixed point.

Neighbours are the pairs kernel C walks: j another particle with mass and
|x_i - x_j| < 2 max(h_i, h_j), the positions the window's sorted ones
(pos[g] + shift). Each chooses by the device of its inputs, as the kernel
wrappers do: a CUDA tensor launches the hand-written kernel
(``sphax_torch/csrc/rung_limit.cu``), a CPU tensor runs the plain torch
version beside it (``*_plain``), which the kernels equal exactly on the
card: the pair test rounds each operation as the kernels do, and the rest
is integer.
"""
from __future__ import annotations

import torch

from sphax_torch.neighbors.window import WindowData, WindowSpec
from sphax_torch.physics.cuda_call import (check_fields, check_index,
                                           launch, plain_here, ptr)

# Launches of each CUDA kernel; a wrapper adds one where it launches.
LAUNCHES = {"rung_limit_tick": 0, "rung_limit_sync": 0}


def sync_passes(n_rungs: int, a: int) -> int:
    """Jacobi passes of ``sync`` that reach its fixed point from any rungs
    in [0, n_rungs - 1]: a path of p hops caps a row at a p plus a rung,
    which binds only while a p < n_rungs - 1."""
    return max(0, (n_rungs - 2) // a)


def need_rung(rung, k: int, n_rungs: int):
    """The least rung whose step, from the opening of a row on ``rung``
    that does not close at tick ``k``, ends after tick k: ceil(log2(k + 2
    - k0)) with k0 = k - k mod 2^rung, the bit length of k mod 2^rung + 1."""
    x = torch.bitwise_and((1 << rung.long()) - 1, k) + 1
    return sum((x >= (1 << b)).to(torch.int32) for b in range(n_rungs))


# ---------------------------------------------------------------------------
# plain torch versions (CPU path, and the reference on the card)
# ---------------------------------------------------------------------------


def _sorted(wd: WindowData, pos, h, mass, rung):
    """The sorted rows' original index, position, h, mass (0 on pad rows),
    rung and realness."""
    n = pos.shape[0]
    g = wd.g.long()
    pad = g >= n
    gc = torch.where(pad, 0, g)
    return (g, pos[gc] + wd.shift_s, h[gc], torch.where(pad, 0, mass[gc]),
            rung[gc], wd.is_real & ~pad)


def neighbour_pairs(wd: WindowData, spec: WindowSpec, walks, x, h, mass, g,
                    block: int = 1 << 21):
    """Yields (i, j) a block of groups at a time: sorted rows, i a walking
    row of ``walks`` [Ns] and j a candidate of its group that is a
    neighbour: another particle with mass, |x_i - x_j| < 2 max(h_i, h_j),
    each operation rounded as the kernels round it. A group's candidates
    are first culled as the kernels cull them (those with mass within 2
    max(h_max, h_j), 1e-3 wider, of the box of its walking rows), which
    drops no neighbour. A row of overlapping segments can come twice. The
    pairs of every row of a 256^3 lattice would take tens of GB at once,
    so the callers reduce each block as it comes."""
    T, S, dev = spec.group, spec.wseg, x.device
    groups = torch.nonzero(walks.reshape(-1, T).any(1)).reshape(-1)
    ar_s = torch.arange(S, device=dev)
    ar_t = torch.arange(T, device=dev)
    width = spec.n_seg * S
    step = max(1, block // width)
    for b0 in range(0, groups.numel(), step):
        gb = groups[b0:b0 + step]
        tb = gb.numel()
        cand = (wd.w_lo[gb].long()[..., None] + ar_s)           # [tb, seg, S]
        valid = (ar_s < 128 * wd.w_nact[gb].long()[..., None]).reshape(
            tb, width)
        cand = torch.where(valid, cand.reshape(tb, width), 0)
        rows = gb[:, None] * T + ar_t                           # [tb, T]
        w = walks[rows]
        xr = x[rows]
        lo = torch.where(w[..., None], xr, float("inf")).amin(1)
        hi = torch.where(w[..., None], xr, -float("inf")).amax(1)
        h_max = torch.where(w, h[rows], 0.0).amax(1)
        xc = x[cand]                                            # [tb, W, 3]
        gap = torch.clamp_min(torch.maximum(lo[:, None] - xc,
                                            xc - hi[:, None]), 0.0)
        reach = 2.002 * torch.maximum(h_max[:, None], h[cand])
        keep = (valid & (mass[cand] > 0)
                & ((gap * gap).sum(-1) < reach * reach))
        gi, wi = torch.nonzero(keep, as_tuple=True)
        c = cand[gi, wi]                                        # [P]
        rr = rows[gi]                                           # [P, T]
        ok = walks[rr] & (g[rr] != g[c][:, None])
        d = x[rr] - x[c][:, None, :]
        r2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
              + d[..., 2] * d[..., 2])
        hm = torch.maximum(h[rr], h[c][:, None])
        s = hm + hm
        ok &= r2 < s * s
        pi, ti = torch.nonzero(ok, as_tuple=True)
        yield rr[pi, ti], c[pi]


def _neighbour_min(pairs, r_s, n_rungs: int):
    """The lowest rung among each walking sorted row's neighbours, n_rungs
    - 1 where it has none (and off the walking rows), over the blocks of
    ``neighbour_pairs``."""
    m = torch.full_like(r_s, n_rungs - 1)
    for i, j in pairs:
        m.scatter_reduce_(0, i, r_s[j], reduce="amin")
    return m


def tick_plain(wd: WindowData, spec: WindowSpec, pos, h, mass, rung, r_des,
               k: int, a: int, align: int, n_rungs: int):
    """``tick``'s plain version: (m, target, limited)."""
    g, x, h_s, m_s, r_s, real = _sorted(wd, pos, h, mass, rung)
    closes = real & (torch.bitwise_and((1 << r_s.long()) - 1, k + 1) == 0)
    m_sorted = _neighbour_min(neighbour_pairs(wd, spec, closes, x, h_s, m_s,
                                              g), r_s, n_rungs)
    own = torch.nonzero(closes).reshape(-1)
    go = g[own]
    m = torch.full_like(rung, n_rungs - 1)
    m[go] = m_sorted[own]
    rd, ri, mi = r_des[go], rung[go], m[go]
    rl = torch.minimum(rd, mi + a)
    rn = torch.where(rl < ri, rl, torch.clamp_max(rl, align))
    ru = torch.where(rd < ri, rd, torch.clamp_max(rd, align))
    limited = (rn < ru).sum().to(torch.int32).reshape(1)
    # the wake-up: every pair of a closer and a sleeping neighbour above
    pv = torch.full_like(r_s, n_rungs)
    pv[own] = rn + a
    target = rung.clone()
    for i, j in neighbour_pairs(wd, spec, closes, x, h_s, m_s, g):
        rj = r_s[j]
        sleeps = ((torch.bitwise_and((1 << rj.long()) - 1, k + 1) != 0)
                  & (rj > pv[i]))
        i, j, rj = i[sleeps], j[sleeps], rj[sleeps]
        v = torch.maximum(pv[i], need_rung(rj, k, n_rungs))
        lands = v < rj
        target.scatter_reduce_(0, g[j[lands]], v[lands], reduce="amin")
    return m, target, limited


def sync_plain(wd: WindowData, spec: WindowSpec, pos, h, mass, rung, a: int,
               n_rungs: int):
    """``sync``'s plain version: one Jacobi pass."""
    g, x, h_s, m_s, r_s, real = _sorted(wd, pos, h, mass, rung)
    m_sorted = _neighbour_min(neighbour_pairs(wd, spec, real, x, h_s, m_s, g),
                              r_s, n_rungs)
    own = torch.nonzero(real).reshape(-1)
    out = rung.clone()
    out[g[own]] = torch.minimum(r_s[own], m_sorted[own] + a)
    return out


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _check(wd: WindowData, spec: WindowSpec, pos, h, mass, ints: dict):
    n, dim = pos.shape
    Ns = spec.n_sorted
    if dim != 3 or spec.cwidth > 0:
        raise NotImplementedError("the rung limiter's kernels walk the "
                                  "in-place tables of a 3D structure")
    if spec.group % 32 or Ns % 128:
        raise ValueError(f"group {spec.group} and n_sorted {Ns} must be "
                         "multiples of 32 and 128")
    check_fields(pos, dict(pos=(pos, (n, 3)), h=(h, (n,)),
                           mass=(mass, (n,)), shift_s=(wd.shift_s, (Ns, 3))),
                 contiguous=True)
    check_index(pos, "g", wd.g, (Ns,))
    for name in ("w_lo", "w_nact"):
        check_index(pos, name, getattr(wd, name), (spec.n_groups,
                                                   spec.n_seg))
    for name, t in ints.items():
        check_index(pos, name, t, (n,))
    if wd.is_real.dtype != torch.bool or not wd.is_real.is_contiguous():
        raise ValueError("is_real must be a contiguous bool tensor")


def tick(wd: WindowData, spec: WindowSpec, pos, h, mass, rung, r_des,
         k: int, a: int, align: int, n_rungs: int):
    """The tick's pass: (m [n] int32, target [n] int32, limited [1] int32)
    from the state after the closers' derived pass (``pos`` drifted with
    the structure, ``h`` current-best), the current rungs and the closers'
    wanted rungs ``r_des`` (read on closers only); ``align`` is the
    alignment of k + 1 that ``rungs.close_rungs`` applies."""
    if plain_here(pos):
        return tick_plain(wd, spec, pos, h, mass, rung, r_des, k, a, align,
                          n_rungs)
    pos, h, mass = (t.contiguous() for t in (pos, h, mass))
    rung, r_des = rung.contiguous(), r_des.contiguous()
    _check(wd, spec, pos, h, mass, dict(rung=rung, r_des=r_des))
    n = pos.shape[0]
    m = torch.full_like(rung, n_rungs - 1)
    target = rung.clone()
    limited = torch.zeros(1, dtype=torch.int32, device=pos.device)
    launch(LAUNCHES, "rung_limit_tick", pos.dtype, *map(ptr, (
        wd.g, wd.is_real, wd.shift_s, wd.w_lo, wd.w_nact)), spec.n_sorted,
        spec.group, n, *map(ptr, (pos, h, mass, rung, r_des)), int(k),
        int(a), int(align), int(n_rungs), *map(ptr, (m, target, limited)))
    return m, target, limited


def sync(wd: WindowData, spec: WindowSpec, pos, h, mass, rung, a: int,
         n_rungs: int):
    """One pass at a span's sync point: every row's rung capped at its
    neighbours' lowest plus a (read from ``rung``, written anew)."""
    if plain_here(pos):
        return sync_plain(wd, spec, pos, h, mass, rung, a, n_rungs)
    pos, h, mass, rung = (t.contiguous() for t in (pos, h, mass, rung))
    _check(wd, spec, pos, h, mass, dict(rung=rung))
    out = torch.empty_like(rung)
    launch(LAUNCHES, "rung_limit_sync", pos.dtype, *map(ptr, (
        wd.g, wd.is_real, wd.shift_s, wd.w_lo, wd.w_nact)), spec.n_sorted,
        spec.group, pos.shape[0], *map(ptr, (pos, h, mass, rung)), int(a),
        int(n_rungs), ptr(out))
    return out
