"""Sorted pencil-window neighbour structure (torch twin of
``sphax.neighbors.window``).

One stable sort of cell keys and O(N) everything else:

  1. Periodic images ("ghosts") of particles within ``cutoff`` of each box
     face are appended with static per-axis capacities; ghost rows carry
     their source row so owner-computed fields are mirrored onto them with
     one gather between kernel passes.
  2. Extended positions are binned on a uniform grid and sorted by
     row-major cell id with the LAST axis fastest, so each pencil of cells
     is contiguous in sorted order.
  3. A row-group's candidates are 3^(D-1) contiguous runs of sorted rows
     (one per neighbouring pencil), padded to the static width ``wseg``.
     ``overflow`` counts tiles whose true run exceeded wseg plus dropped
     ghosts (must be 0 for exactness).
  4. With ``spec.cwidth > 0`` each group also gets its COMPACTED candidate
     list: the segment runs clipped against each other (``c_lo``,
     ``c_len``), disjoint, concatenated in segment order and capped at
     ``cwidth`` rows (``compact_index``).

Rows beyond a segment's true range lie outside the kernel support or have
zero mass, so the pair kernels need no mask beyond a first-occurrence
dedup across segments (none at all on the compacted lists).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from sphax_torch.core.state import Domain
from sphax_torch.io.metrics import span

_BIG = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class WindowSpec:
    """Static window-structure parameters (same fields as
    ``sphax.neighbors.window.WindowSpec``)."""

    res: Tuple[int, ...]          # interior cells per axis (fast axis: cells
    #                               cutoff / fast_sub wide)
    cutoff: float                 # neighbour search radius (>= 2 h_max)
    ghost_caps: Tuple[int, ...]   # ghost capacity per axis pass (per face)
    tile: int                     # rows per tile (T)
    wseg: int                     # static width of each pencil segment
    n_sorted: int                 # padded sorted-array length
    fast_sub: int = 1             # fast-axis cell subdivision
    cwidth: int = 0               # candidate compaction width: rows per
    #                               row-group's compacted list (multiple of
    #                               128; 0 = off)
    rgroups: int = 1              # row-groups per tile: windows are per
    #                               group of tile/rgroups sorted rows

    @property
    def dim(self) -> int:
        return len(self.res)

    @property
    def n_seg(self) -> int:
        return 3 ** (self.dim - 1)

    @property
    def n_tiles(self) -> int:
        return self.n_sorted // self.tile

    @property
    def group(self) -> int:
        """Rows per window-group (the granularity of w_lo/w_nact)."""
        return self.tile // self.rgroups

    @property
    def n_groups(self) -> int:
        return self.n_sorted // self.group


def _pencil_offsets(dim: int):
    """Offsets over the slow axes (all but the last)."""
    if dim == 1:
        return [()]
    return list(itertools.product((-1, 0, 1), repeat=dim - 1))


def plan_windows(domain: Domain, h_max: float, n: int, dim: int,
                 tile: int = 128, wseg: int = 0, cutoff_scale: float = 1.0,
                 ghost_safety: float = 2.0, seg_safety: float = 1.2,
                 fast_sub: int = 1, rgroups: int = 1) -> WindowSpec:
    """Host-side parameter choice (cutoff = 2 h_max * cutoff_scale); the
    same arithmetic as ``sphax.neighbors.window.plan_windows``."""
    lo = domain.lo.detach().cpu().double().numpy()
    hi = domain.hi.detach().cpu().double().numpy()
    ext = hi - lo
    cutoff = 2.0 * float(h_max) * cutoff_scale
    res = np.maximum(1, np.floor(ext / cutoff).astype(int))
    if fast_sub > 1:
        res[-1] = max(int(np.floor(ext[-1] / (cutoff / fast_sub))), 1)
    if np.any(res < 2) or res[-1] < 2 * fast_sub:
        # with res=1 a particle and its own periodic image can both fall
        # inside the cutoff, which the dedup cannot distinguish
        raise ValueError(
            f"box too small for window engine at cutoff {cutoff:.4g} "
            f"(res={tuple(res)}); use the dense or cell-list engine")
    per = domain.periodic_axes(dim)
    # one ghost pass per periodic axis; each pass images BOTH faces of the
    # accumulated array, so later passes budget for earlier passes' ghosts
    caps = []
    n_acc = float(n)
    for d in range(dim):
        if not per[d]:
            caps.append(0)
            continue
        frac = min(1.0, cutoff / ext[d])
        cap = max(int(np.ceil(n_acc * frac * ghost_safety / 8.0) * 8), 8)
        caps.append(cap)
        n_acc += 2.0 * cap
    if tile % (rgroups * 8):
        raise ValueError(f"tile={tile} must be a multiple of 8*rgroups "
                         f"(rgroups={rgroups})")
    n_ghost = 2 * sum(caps)
    n_raw = n + n_ghost
    if wseg <= 0:
        # a group's fast-axis run spans ~group rows + ~8.5 cells of
        # occupancy at a pencil boundary; +128 absorbs the 128-row
        # alignment of window starts (plan_measured refines this)
        occ = n_raw * fast_sub / max(int(np.prod(res)), 1)
        run_est = (tile // rgroups + 8.5 * occ) * seg_safety
        wseg = int(np.ceil(max(run_est, 1.0) / 128.0) * 128) + 128
    wseg = min(wseg, int(np.ceil(n_raw / 128.0) * 128))
    quantum = int(np.lcm(tile, 128))
    n_sorted = int(np.ceil(max(n_raw, wseg) / quantum) * quantum)
    return WindowSpec(res=tuple(int(r) for r in res), cutoff=float(cutoff),
                      ghost_caps=tuple(caps), tile=tile, wseg=int(wseg),
                      n_sorted=n_sorted, fast_sub=int(fast_sub),
                      rgroups=int(rgroups))


class WindowData(NamedTuple):
    """Built structure over one snapshot of positions (all int tables are
    int32, the type the CUDA kernels take).

    g:        [Ns] original row feeding each sorted row (N = zero-mass pad)
    src:      [Ns] sorted row holding the OWNER copy of each sorted row
    inv:      [N] owner sorted row per ORIGINAL row (unsort = one gather)
    is_real:  [Ns] bool, True where the sorted row is an original particle
    pos_s:    [Ns, D] sorted extended positions (images pre-shifted)
    shift_s:  [Ns, D] image shift per sorted row
    w_lo:     [n_groups, n_seg] segment start row per row-group (128-aligned)
    w_nact:   [n_groups, n_seg] active 128-row blocks per segment
    t_lo:     [n_tiles, n_seg] tile-union window start (128-aligned)
    t_nact:   [n_tiles, n_seg] active 128-blocks of the union window
    overflow: [] union runs past wseg + dropped ghosts (+ groups whose
              compacted count exceeds cwidth, spec.cwidth > 0); must be 0
    max_run:  [] largest aligned union window length actually required

    With spec.cwidth > 0 (else None), the compacted candidate runs:
    c_lo:     [n_groups, n_seg] first row of each segment's clipped run
    c_len:    [n_groups, n_seg] its length (runs are disjoint, in order)
    c_n:      [n_groups] true compacted count, the sum of c_len
    c_max:    [] largest c_n (for plan_compact)
    """

    g: torch.Tensor
    src: torch.Tensor
    inv: torch.Tensor
    is_real: torch.Tensor
    pos_s: torch.Tensor
    shift_s: torch.Tensor
    w_lo: torch.Tensor
    w_nact: torch.Tensor
    t_lo: torch.Tensor
    t_nact: torch.Tensor
    overflow: torch.Tensor
    max_run: torch.Tensor
    c_lo: torch.Tensor = None
    c_len: torch.Tensor = None
    c_n: torch.Tensor = None
    c_max: torch.Tensor = None


def _pack_offset(mask, orig_idx, cap: int, n: int):
    """First-``cap`` indices of True entries (row order), sentinel ``n``
    beyond/over capacity, plus the dropped count. ``orig_idx`` must be
    strictly increasing with values < ``n``."""
    key = torch.where(mask, orig_idx.to(torch.int32),
                      torch.full_like(orig_idx, n, dtype=torch.int32))
    take = torch.sort(key, stable=True).values[:cap]
    dropped = torch.clamp_min(mask.sum() - cap, 0)
    return take, dropped


# window structures built by this process (``build`` calls)
BUILDS = {"n": 0}
# kernel A's candidates over this process's builds: ``sums`` is a device
# tensor [candidate rows summed over the rows that define windows, those
# rows], added to by each build (``count_candidates``) without a host read;
# a build on another device starts it afresh
CANDIDATES = {"sums": None}


def candidate_sums(w_lo, w_nact, c_n, real_rows, spec: WindowSpec):
    """[candidates, rows] of one build, int64 on the tables' device: the
    rows kernel A's walk offers each row of a group (in place: the union of
    the segments' 128 w_nact rows from w_lo, as the kernels clip each start
    at the largest end before it; compact: c_n cut at cwidth), summed over
    the ``real_rows`` ([n_groups, group] bool) that define windows, and the
    count of those rows."""
    if spec.cwidth > 0:
        per = torch.clamp_max(c_n, spec.cwidth)
    else:
        # segment-major [n_seg, n_groups]: a running max down the short
        # outer axis is one pass, where one along a row of 3 or 9 is a slow
        # scan kernel
        lo, nact = w_lo.T, w_nact.T
        hi = torch.add(lo, nact, alpha=128)
        ends = torch.where(nact > 0, hi, 0).contiguous().cummax(0).values
        clip = torch.nn.functional.pad(ends[:-1], (0, 0, 1, 0))
        per = torch.clamp_min(hi - torch.maximum(lo, clip), 0).sum(0)
    rows = real_rows.sum(1)
    return torch.stack([(per * rows).sum(), rows.sum()])


def count_candidates(sums):
    """Add one build's ``candidate_sums`` to ``CANDIDATES``, on the device
    (no host read)."""
    prev = CANDIDATES["sums"]
    CANDIDATES["sums"] = (sums.clone() if prev is None
                          or prev.device != sums.device else prev + sums)


_CONSTS = {}


def _consts(spec: WindowSpec, dtype, dev):
    """(res, cutoff, fast-axis layers, res as int32, key strides) of a
    spec on a device, made once: a tensor made from host memory waits for
    the stream, and a CUDA graph cannot hold that wait."""
    key = (spec, dtype, dev)
    if key not in _CONSTS:
        i32 = dict(dtype=torch.int32, device=dev)
        layers = np.array([1] * (spec.dim - 1) + [spec.fast_sub], np.int64)
        res_ext = [r + 2 * int(l) for r, l in zip(spec.res, layers)]
        strides = np.concatenate([np.cumprod(res_ext[::-1])[-2::-1], [1]])
        _CONSTS[key] = (torch.tensor(spec.res, dtype=dtype, device=dev),
                        torch.tensor(spec.cutoff, dtype=dtype, device=dev),
                        torch.tensor(layers, **i32),
                        torch.tensor(spec.res, **i32),
                        torch.tensor(strides, **i32))
    return _CONSTS[key]


def build(pos, domain: Domain, spec: WindowSpec, active=None,
          image=None) -> WindowData:
    """Build the sorted pencil-window structure (one stable key sort).

    ``active`` ([n] bool, optional): rows with active=False (padding or
    slab-ghost rows of a shard, ``sphax_torch.dist.wslab``) are still
    sorted and still appear in other rows' candidate windows, but they do
    not define windows; their own outputs are don't-care.

    ``image`` ([n] bool, optional, defaults to ``active``): rows allowed to
    spawn periodic images. A shard passes image = (mass > 0) and active =
    its local real rows: slab ghosts near a transverse face must still be
    imaged, since their images are candidates of corner particles.

    With both None every real row defines windows and spawns images, and
    the tables are those of a build without masks."""
    with span("sphax_torch.build"):
        wd, sums = _build(pos, domain, spec, active, image)
    _tally(sums)
    return wd


def _tally(sums):
    """Count one build in ``BUILDS`` and its candidates in ``CANDIDATES``."""
    BUILDS["n"] += 1
    count_candidates(sums)


def _build(pos, domain: Domain, spec: WindowSpec, active, image):
    """``build``'s body: (WindowData, ``candidate_sums``). On a periodic
    box it reads nothing back to the host and never waits for the stream
    (after the first build of a spec on a device), so a CUDA graph can hold
    it (``GraphedBuild``)."""
    if image is None:
        image = active
    n, dim = pos.shape
    dtype, dev = pos.dtype, pos.device
    i32 = dict(dtype=torch.int32, device=dev)
    lo = domain.lo.to(dtype)
    ext = domain.extent.to(dtype)
    res, cut, layers_t, res_i, strides_t = _consts(spec, dtype, dev)
    cell = ext / res
    idx = torch.arange(n, **i32)

    # ---- periodic images within `cutoff` of each face, one pass per axis;
    # each pass images both faces of the ACCUMULATED array, so edge/corner
    # images appear as ghosts-of-ghosts
    cur_pos, cur_orig = pos, idx
    cur_shift = torch.zeros((n, dim), dtype=dtype, device=dev)
    ghost_drop = torch.zeros((), dtype=torch.int64, device=dev)
    for d in range(dim):
        cap = spec.ghost_caps[d]
        if cap == 0:
            continue
        nc = cur_pos.shape[0]
        rows_c = torch.arange(nc, **i32)
        off = torch.zeros((dim,), dtype=dtype, device=dev)
        off[d] = ext[d]
        new_pos, new_orig, new_shift = [cur_pos], [cur_orig], [cur_shift]
        for sgn, m in ((1.0, cur_pos[:, d] < lo[d] + cut),
                       (-1.0, cur_pos[:, d] > lo[d] + ext[d] - cut)):
            m = m & (cur_orig < n)
            if image is not None:
                m = m & torch.cat([image, image.new_zeros(1)])[
                    torch.clamp_max(cur_orig, n).long()]
            take, dropped = _pack_offset(m, rows_c, cap, nc)
            ghost_drop = ghost_drop + dropped
            tk = torch.clamp_max(take, nc - 1)
            invalid = take >= nc
            new_pos.append(cur_pos[tk] + sgn * off)
            new_orig.append(torch.where(invalid, n, cur_orig[tk]))
            new_shift.append(torch.where(invalid[:, None], 0.0,
                                         cur_shift[tk] + sgn * off))
        cur_pos = torch.cat(new_pos)
        cur_orig = torch.cat(new_orig)
        cur_shift = torch.cat(new_shift)

    n_raw = cur_orig.shape[0]
    n_pad = spec.n_sorted - n_raw
    if n_pad < 0:
        raise ValueError("spec.n_sorted too small for ghosts; re-plan")
    orig = torch.cat([cur_orig, torch.full((n_pad,), n, **i32)])
    shift = torch.cat([cur_shift, cur_shift.new_zeros((n_pad, dim))])
    pos_e = torch.cat([cur_pos, cur_pos.new_zeros((n_pad, dim))])
    valid = orig < n

    # ---- extended-grid row-major keys (last axis fastest). Binning
    # coordinates are clamped to the box on NON-periodic axes (exact: pair
    # distances use the true positions).
    per_ax = domain.periodic_axes(dim)
    if not all(per_ax):
        clampmask = torch.tensor([not p for p in per_ax], device=dev)
        eps = 1e-6 * ext
        bin_pos = torch.minimum(torch.maximum(pos_e, lo + 0 * ext),
                                lo + ext - eps)
        bin_pos = torch.where(clampmask, bin_pos, pos_e)
    else:
        bin_pos = pos_e
    # the fast axis gets fast_sub ghost-cell layers each side (the cutoff
    # band spans fast_sub fine cells there), the transverse axes one
    layers = np.array([1] * (dim - 1) + [spec.fast_sub], np.int64)
    c = torch.floor((bin_pos - lo) / cell).to(torch.int32) + layers_t
    c = torch.minimum(torch.clamp_min(c, 0), res_i + 2 * layers_t - 1)
    res_ext = tuple(r + 2 * int(l) for r, l in zip(spec.res, layers))
    strides = np.concatenate([np.cumprod(res_ext[::-1])[-2::-1], [1]])

    key = torch.where(valid, (c * strides_t).sum(-1, dtype=torch.int32),
                      _BIG)
    key_s, order = torch.sort(key, stable=True)
    order = order.to(torch.int32)
    is_real = order < n
    pos_s = pos_e[order]
    shift_s = shift[order]
    g = orig[order]

    Ns = spec.n_sorted
    rows = torch.arange(Ns, **i32)
    # duplicate writes land only in the pad slot n (non-real rows), whose
    # value is unspecified — as in the reference
    inv_real = torch.full((n + 1,), Ns - 1, **i32)
    inv_real[torch.where(is_real, g, n).long()] = rows
    src = inv_real[torch.clamp_max(g, n)]

    # ---- per-group pencil runs: dense cell-start table (scatter-min
    # plus a reverse cumulative min; empty cells inherit the next
    # cell's start). `first` is monotone, so a group's window bounds
    # need only the min/max REAL key in the group.
    T, S = spec.group, spec.wseg
    nt = spec.n_groups
    ncells_ext = int(np.prod(res_ext))
    n_valid = valid.sum().to(torch.int32)
    first = torch.full((ncells_ext + 1,), Ns, **i32)
    first[ncells_ext] = torch.minimum(first[ncells_ext], n_valid)
    first.scatter_reduce_(
        0, torch.clamp_max(key_s, ncells_ext).long(),
        torch.where(key_s < ncells_ext, rows, Ns), reduce="amin")
    first = torch.flip(torch.cummin(torch.flip(first, (0,)), 0).values,
                       (0,))

    # only REAL (and, with ``active``, active) rows define windows
    kt = key_s.reshape(nt, T)
    if active is None:
        rt = is_real.reshape(nt, T)
    else:
        act = torch.cat([active, active.new_zeros(1)])
        rt = (is_real & act[torch.clamp_max(g, n).long()]).reshape(nt, T)
    kmin_t = torch.where(rt, kt, _BIG).amin(1)
    kmax_t = torch.where(rt, kt, -1).amax(1)
    has_real = kmax_t >= 0
    # clamp BIG before offsetting (masked below; avoids int32 wraparound)
    kmin_t = torch.clamp_max(kmin_t, ncells_ext)
    reach = spec.fast_sub
    starts, ends = [], []
    for poff in _pencil_offsets(dim):
        delta = int(np.dot(poff, strides[:-1])) if dim > 1 else 0
        ws = first[torch.clamp(kmin_t + (delta - reach), 0, ncells_ext)]
        we = first[torch.clamp(kmax_t + (delta + reach + 1), 0,
                               ncells_ext)]
        starts.append(torch.where(has_real, ws, Ns))
        ends.append(torch.where(has_real, we, 0))
    ws_t = torch.stack(starts, -1)  # [nt, n_seg]
    we_t = torch.stack(ends, -1)

    # window starts aligned down to 128 rows (the TPU's lane tiling, kept
    # so the tables equal the reference's)
    w_lo = torch.clamp((ws_t // 128) * 128, 0, Ns - S)
    w_len = torch.clamp_min(we_t - w_lo, 0)
    w_nact = torch.clamp(-(-w_len // 128), 0, S // 128).to(torch.int32)

    # per-TILE union of the R group windows; overflow and max_run are
    # judged against the union run
    R = spec.rgroups
    if R > 1:
        n_seg = spec.n_seg
        ws_u = ws_t.reshape(spec.n_tiles, R, n_seg).amin(1)
        we_u = we_t.reshape(spec.n_tiles, R, n_seg).amax(1)
    else:
        ws_u, we_u = ws_t, we_t
    t_lo = torch.clamp((ws_u // 128) * 128, 0, Ns - S)
    t_len = torch.clamp_min(we_u - t_lo, 0)
    t_nact = torch.clamp(-(-t_len // 128), 0, S // 128).to(torch.int32)
    overflow = ((t_len > S).sum() + ghost_drop).to(torch.int32)
    max_run = (we_u - torch.clamp_min((ws_u // 128) * 128, 0)).amax()
    if R == 1:
        t_lo, t_nact = w_lo, w_nact

    # ---- per-group candidate compaction (spec.cwidth > 0). The segment
    # ranges [ws, we) rise with the segment offset, so segment s overlaps
    # the earlier ones' union only below their running maximum end:
    # clipping its start there gives disjoint runs whose concatenation is
    # the group's exact candidate set, with no duplicates and no 128-row
    # alignment
    c_lo = c_len = c_n = c_max = None
    if spec.cwidth > 0:
        we_prev = torch.cat([torch.zeros((nt, 1), **i32),
                             torch.cummax(we_t, 1).values[:, :-1]], 1)
        c_lo = torch.maximum(ws_t, we_prev).contiguous()
        c_len = torch.clamp_min(we_t - c_lo, 0).contiguous()
        c_n = c_len.sum(1, dtype=torch.int32)
        overflow = (overflow + (c_n > spec.cwidth).sum()).to(torch.int32)
        c_max = c_n.amax()

    wd = WindowData(g=g, src=src, inv=inv_real[:n], is_real=is_real,
                    pos_s=pos_s, shift_s=shift_s, w_lo=w_lo,
                    w_nact=w_nact, t_lo=t_lo, t_nact=t_nact,
                    overflow=overflow, max_run=max_run, c_lo=c_lo,
                    c_len=c_len, c_n=c_n, c_max=c_max)
    return wd, candidate_sums(w_lo, w_nact, c_n, rt, spec)


class GraphedBuild:
    """``build`` of a periodic box on a card as one CUDA graph, with the
    wrap into the box before it, for one spec and one shape of positions.
    The graph owns its inputs: the [n, D] positions ``pos`` and the box's
    corners, which a call copies in. Replaying it makes one launch where
    ``build`` makes some 300 small ones from the host, which bind a box
    whose pair walks are short (a 2D box of 1.5e6 particles). The structure
    it returns, and the wrapped positions in ``pos``, are the graph's own
    and hold until the next call; the buffers of its intermediate values
    stay reserved by the graph, and none counts as allocated between
    replays."""

    def __init__(self, pos, domain: Domain, spec: WindowSpec):
        self.spec = spec
        self.pos = pos.clone()
        self.box = Domain(lo=domain.lo.clone(), hi=domain.hi.clone())
        # warm up off the capture: the constants, the sort's workspace
        side = torch.cuda.Stream(device=pos.device)
        side.wait_stream(torch.cuda.current_stream(pos.device))
        with torch.cuda.stream(side):
            self._body()
        torch.cuda.current_stream(pos.device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.wd, self.sums = self._body()

    def _body(self):
        self.pos.copy_(self.box.wrap(self.pos))
        return _build(self.pos, self.box, self.spec, None, None)

    def __call__(self, pos, domain: Domain) -> WindowData:
        """Wrap ``pos`` into ``domain`` (a periodic box) in the graph's
        ``pos`` and build the structure over it."""
        if pos is not self.pos:
            self.pos.copy_(pos)
        self.box.lo.copy_(domain.lo)
        self.box.hi.copy_(domain.hi)
        with span("sphax_torch.build"):
            self.graph.replay()
        _tally(self.sums)
        return self.wd


def compact_index(wd: WindowData, spec: WindowSpec, groups=None):
    """The compacted candidate table of the row-groups ``groups`` (an index
    tensor; all when None): [n, cwidth] int32 sorted rows, the runs (c_lo,
    c_len) concatenated in segment order and cut at cwidth; entries past
    c_n point at the last sorted row. Equal to the reference build's
    ``c_idx``. The CUDA kernels walk the runs in place and never build
    it."""
    c_lo, c_len = ((wd.c_lo, wd.c_len) if groups is None
                   else (wd.c_lo[groups], wd.c_len[groups]))
    C = spec.cwidth
    off = torch.cumsum(c_len, 1) - c_len           # exclusive prefix
    k = torch.arange(C, dtype=off.dtype, device=off.device)[None, :]
    idx = torch.full((c_lo.shape[0], C), spec.n_sorted - 1,
                     dtype=torch.int32, device=c_lo.device)
    for s in range(spec.n_seg):
        o, ln = off[:, s:s + 1], c_len[:, s:s + 1]
        m = (k >= o) & (k < o + ln)
        idx = torch.where(m, (c_lo[:, s:s + 1] + (k - o)).to(torch.int32),
                          idx)
    return idx


def gather_sorted(field_orig, wd: WindowData, fill=0.0):
    """[N, ...] original-order field -> [Ns, ...] sorted order (owner
    values)."""
    n = field_orig.shape[0]
    pad = field_orig.new_full((1,) + tuple(field_orig.shape[1:]), fill)
    return torch.cat([field_orig, pad])[torch.clamp_max(wd.g, n)]


def gather_sorted_cols(packed, wd: WindowData, fills):
    """ONE sorted gather of K column-stacked fields ([N, K] -> [Ns, K]);
    ``fills`` gives each column's value on pad rows."""
    n = packed.shape[0]
    pad = torch.tensor(fills, dtype=packed.dtype, device=packed.device)[None]
    return torch.cat([packed, pad])[torch.clamp_max(wd.g, n)]


def mirror_owner(field_sorted, wd: WindowData):
    """Replace ghost rows with their owner's value (one gather)."""
    return field_sorted[wd.src]


def scatter_real(field_sorted, wd: WindowData, n: int):
    """[Ns, ...] sorted -> [N, ...] original order (one gather through the
    inverse permutation)."""
    return field_sorted[wd.inv]


def refresh_pos(pos, wd: WindowData):
    """Sorted extended positions for NEW particle positions using a stale
    structure (valid while drift < skin/2)."""
    return gather_sorted(pos, wd) + wd.shift_s


def gather_cands(cols_sorted, wd: WindowData, spec: WindowSpec,
                 mass_col: int):
    """The compacted candidate buffer: [Ns, K] sorted-order fields ->
    [n_groups * cwidth, K] candidate-major rows (one row gather), with the
    pair-weight column ``mass_col`` zeroed on the padding entries past each
    group's c_n, so they contribute nothing. For the plain versions and the
    tests: at N = 1e6 it is about 2 GB."""
    out = cols_sorted[compact_index(wd, spec).reshape(-1).long()]
    live = (torch.arange(spec.cwidth, device=out.device)[None, :]
            < wd.c_n[:, None]).reshape(-1)
    out[:, mass_col] = torch.where(live, out[:, mass_col], 0.0)
    return out


def plan_compact(pos, domain: Domain, h_max: float, dim: int,
                 headroom: float = 1.2, **kw) -> WindowSpec:
    """plan_measured plus the measured compaction width: one probe build
    at cwidth = 128 (c_max is the true count whatever the width), then
    cwidth = c_max * headroom rounded up to 128. The overflow counter
    catches later growth, as for wseg."""
    spec = plan_measured(pos, domain, h_max, dim, **kw)
    wd = build(pos, domain, dataclasses.replace(spec, cwidth=128))
    cw = int(np.ceil(int(wd.c_max) * headroom / 128.0) * 128)
    return dataclasses.replace(spec, cwidth=max(cw, 128))


def plan_measured(pos, domain: Domain, h_max: float, dim: int,
                  headroom: float = 1.15, **kw) -> WindowSpec:
    """Plan, build once, and re-plan wseg to the measured max window length
    times ``headroom`` (rounded up to 128). One extra build at setup."""
    n = pos.shape[0]
    spec = plan_windows(domain, h_max, n, dim, **kw)
    wd = build(pos, domain, spec)
    need = int(wd.max_run) * headroom
    wseg = max(int(np.ceil(need / 128.0) * 128), 128)
    wseg = min(wseg, int(np.ceil(spec.n_sorted / 128.0) * 128))
    if wseg == spec.wseg:
        return spec
    q = int(np.lcm(spec.tile, 128))
    n_sorted = int(np.ceil(max(spec.n_sorted, wseg) / q) * q)
    return dataclasses.replace(spec, wseg=wseg, n_sorted=n_sorted)
