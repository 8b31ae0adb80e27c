"""The warp cull of the CUDA kernels A and C, held as plain torch.

``window_kernels.cull_plain`` states the rule the kernels apply before a
walk: a warp of 32 sorted rows keeps a candidate of its group's table when
the candidate carries mass and lies within the reach of the box of the
warp's rows that carry mass. These tests hold the rule on the CPU, in
float64, on inputs made from a numpy seed:

(a) every pair inside the support of a real row (r < 2 h_i for kernel A,
    r < 2 max(h_i, h_j) for kernel C, 0 < r <= cutoff in C's gravity mode)
    is among its warp's survivors, in 3D, 2D and 1D, in place and compact,
    on a ``mask_structure``d table, on the Sedov lattice in a periodic and
    in an open box, where the last warp with candidates mixes real rows
    with rows that carry no mass;
(b) the plain versions of kernels A and C summed over the survivors only
    equal the full plain sums at 1e-12: the cull removes exact zeros;
(c) a warp that straddles two pencils keeps every live pair;
(d) after a Newton update that grows h by half, the list made for the old
    h misses live pairs and a fresh cull does not, which is why kernel A
    culls before every walk;
(e) the margins of the rule here are the ones in the kernels' source, and
    the in-place ranges of every structure rise with the segment, which is
    what lets the kernels dedup by clipping a segment's start;
(f) the pair walks of kernels A and C (``walk_counts`` at each kernel's
    rule, batch and step): their lane fill never passes 1, they never run
    the pair arithmetic more often than the walk in which every lane
    visits every survivor, their steps equal those of a loop that follows
    the kernels' batches, and their batches and steps are the ones in the
    kernels' source.
"""
import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from sphax_torch import configs
from sphax_torch.core.state import box
from sphax_torch.ics import kh as kh_ics
from sphax_torch.ics import sedov as sedov_ics
from sphax_torch.ics import turbulence
from sphax_torch.integrate import rungs
from sphax_torch.neighbors import window as win
from sphax_torch.physics import pm, wengine
from sphax_torch.physics import window_kernels as wk

torch.set_num_threads(1)

F64 = torch.float64
BENCH_KNOBS = dict(cutoff_scale=1.05, ghost_safety=1.4, fast_sub=3, rgroups=2)
CLI_KNOBS = dict(cutoff_scale=1.25, fast_sub=3, rgroups=2)
A_ARGS = ("pos_s", "mass_s", "h0_s")
C_ARGS = ("pos_s", "vel_s", "mass_s", "h_s", "rho_s", "P_s", "cs_s", "om_s",
          "bf_s")


def _positions(name, seed):
    """(pos [N, D], mass [N], h [N], periodic, h_margin, knobs)."""
    rng = np.random.default_rng(seed)
    if name == "turb":
        ic = turbulence.build(n_side=14)
        # the lattice with a velocity-free jitter of 0.2 spacings
        jitter = 0.2 / 14 * rng.uniform(-1, 1, ic["pos"].shape)
        pos = np.mod(ic["pos"] + jitter, 1.0)
        return pos, ic["mass"], ic["h"], True, 1.05, BENCH_KNOBS
    if name == "kh":
        ic = kh_ics.build(nx=64)
        return ic["pos"], ic["mass"], ic["h"], True, 1.3, CLI_KNOBS
    if name == "line":
        n = 4096
        pos = (np.arange(n) + 0.5 + 0.2 * rng.uniform(-1, 1, n))[:, None] / n
        return (pos, np.full(n, 1.0 / n), np.full(n, 1.3 / n), True, 1.3,
                CLI_KNOBS)
    ic = sedov_ics.build(n_side=11)
    pos = ic["pos"] + 0.2 / 11 * rng.uniform(-1, 1, ic["pos"].shape)
    periodic = name == "sedov"
    pos = np.mod(pos, 1.0) if periodic else np.clip(pos, 0.0, 1.0 - 1e-9)
    return pos, ic["mass"], ic["h"], periodic, 1.5, CLI_KNOBS


def _inputs(name, compact=False, seed=5):
    """The structure and the sorted kernel inputs of one geometry; h varies
    by a seeded factor in [0.8, 1.04] from row to row (2 h stays inside the
    cutoff the windows were planned for), owner-consistent on ghost
    rows."""
    pos, mass, h, periodic, margin, knobs = _positions(name, seed)
    rng = np.random.default_rng(seed + 1)
    n, dim = pos.shape
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=F64)
    dom = box(torch.zeros(dim, dtype=F64), torch.ones(dim, dtype=F64),
              periodic=periodic)
    plan = win.plan_compact if compact else win.plan_measured
    spec = plan(t(pos), dom, h_max=float(h.max()) * margin, dim=dim, **knobs)
    wd = win.build(t(pos), dom, spec)
    assert int(wd.overflow) == 0
    rho = rng.uniform(0.8, 1.2, n)
    cols = {"vel_s": (0.4 * rng.standard_normal((n, dim)), 0.0),
            "mass_s": (mass, 0.0),
            "h0_s": (h * rng.uniform(0.8, 1.04, n), 1.0),
            "rho_s": (rho, 1.0), "P_s": (rho * rng.uniform(0.9, 1.1, n), 1.0),
            "cs_s": (rng.uniform(0.8, 1.2, n), 1.0),
            "om_s": (rng.uniform(0.9, 1.1, n), 1.0),
            "bf_s": (rng.uniform(0.0, 1.0, n), 0.0)}
    f = {k: win.gather_sorted(t(v), wd, fill) for k, (v, fill) in cols.items()}
    f["h_s"] = f["h0_s"]
    f["pos_s"] = wd.pos_s
    return spec, wd, f, dom


def _live_pairs(spec, wd, f, groups, idx, valid, kind, rcut, ghosts=False):
    """live [G, group, W]: the pairs of each real own row (with ``ghosts``
    of each own row that carries mass) with the valid candidates that
    carry mass and lie inside the support of ``kind``."""
    T = spec.group
    rows = groups[:, None] * T + torch.arange(T)
    xi, xj = f["pos_s"][rows], f["pos_s"][idx]
    r2 = ((xi[:, :, None] - xj[:, None]) ** 2).sum(-1)
    hi = 2.0 * f["h_s"][rows][:, :, None]
    if kind == "A":
        inside = r2 < hi * hi
    else:
        hc = torch.maximum(hi, 2.0 * f["h_s"][idx][:, None])
        inside = r2 < hc * hc
        if kind == "grav":
            inside |= (r2 > 0) & (r2 <= rcut ** 2)
    own = f["mass_s"][rows] > 0 if ghosts else wd.is_real[rows]
    cand = valid & (f["mass_s"][idx] > 0)
    return inside & own[:, :, None] & cand[:, None]


def _missed(spec, wd, f, kind, rcut=None, h_cull=None):
    """(live pairs the cull drops, live pairs, survivors, valid
    candidates), summed over every warp with candidates."""
    h_cull = f["h_s"] if h_cull is None else h_cull
    groups, idx, valid, keep = wk.cull_plain(
        wd, spec, f["pos_s"], f["mass_s"], h_cull, pair_h=kind != "A",
        rcut=rcut)
    missed = live_n = 0
    for b in range(0, groups.numel(), 8):
        s = slice(b, b + 8)
        live = _live_pairs(spec, wd, f, groups[s], idx[s], valid[s], kind,
                           rcut)
        live = live.reshape(live.shape[0], -1, 32, live.shape[-1])
        missed += int((live & ~keep[s][:, :, None]).sum())
        live_n += int(live.sum())
    nw = spec.group // 32
    return missed, live_n, int(keep.sum()), int(valid.sum()) * nw


def _rcut(spec, kind):
    return spec.cutoff if kind == "grav" else None


@pytest.mark.parametrize("name,compact,kind", [
    ("turb", False, "A"), ("turb", False, "C"), ("turb", False, "grav"),
    ("turb", True, "A"), ("turb", True, "C"), ("turb", True, "grav"),
    ("kh", False, "A"), ("kh", False, "C"), ("kh", True, "A"),
    ("kh", True, "C"), ("line", False, "A"), ("line", False, "C"),
    ("line", True, "C"), ("sedov", False, "A"), ("sedov", False, "C"),
])
def test_cull_keeps_every_live_pair(name, compact, kind):
    spec, wd, f, _ = _inputs(name, compact)
    missed, live, kept, cands = _missed(spec, wd, f, kind, _rcut(spec, kind))
    assert live > 0 and missed == 0, (missed, live)
    # the cull is worth its name: it drops candidates (all but the gravity
    # mode, whose reach is the cutoff the windows were planned for)
    assert kept < (0.95 if kind == "grav" else 0.7) * cands, (kept, cands)


@pytest.mark.parametrize("kind", ["A", "C"])
def test_cull_on_a_masked_table(kind):
    """On a ``mask_structure``d table the masked groups have no candidates
    and no warp; the active ones keep every live pair."""
    spec, wd, f, _ = _inputs("turb")
    act = (f["pos_s"] - 0.5).norm(dim=-1) < 0.3
    wm = rungs.mask_structure(wd, spec, act)
    n_act = int(wk._group_active(wm, spec).sum())
    assert 0 < n_act < int(wk._group_active(wd, spec).sum())
    groups = wk.cull_plain(wm, spec, f["pos_s"], f["mass_s"], f["h_s"])[0]
    assert groups.numel() == n_act
    missed, live, _, _ = _missed(spec, wm, f, kind)
    assert live > 0 and missed == 0, (missed, live)


@pytest.mark.parametrize("name", ["sedov_open", "line"])
@pytest.mark.parametrize("kind", ["A", "C"])
def test_boundary_warp_mixes_rows_without_mass(name, kind):
    """The last warp with real rows also holds rows that carry no mass
    (pad rows at the origin with h = 1, unused ghost slots): they stay out
    of its box and its h_max. With them in, h_max = 1 would reach across
    the unit box and the warp would keep every candidate that carries
    mass. Its live pairs are all kept."""
    spec, wd, f, _ = _inputs(name)
    T = spec.group
    groups, idx, valid, keep = wk.cull_plain(
        wd, spec, f["pos_s"], f["mass_s"], f["h_s"], pair_h=kind != "A")
    rows = (groups[:, None] * T + torch.arange(T)).reshape(-1, T // 32, 32)
    has = f["mass_s"][rows] > 0
    mixed = has.any(2) & ~has.all(2) & wd.is_real[rows].any(2)
    assert bool(mixed.any()), "no warp mixes rows with and without mass"
    assert float(f["h_s"][rows][~has].max()) == 1.0
    with_mass = (valid & (f["mass_s"][idx] > 0)).sum(1)[:, None]
    assert bool((keep.sum(2) < with_mass)[mixed].all())
    # a warp of rows without mass only keeps nothing
    assert not bool(keep[~has.any(2)].any())
    missed, live, _, _ = _missed(spec, wd, f, kind)
    assert live > 0 and missed == 0, (missed, live)


def test_warp_that_straddles_two_pencils():
    """Consecutive sorted rows run from the end of one pencil of cells to
    the start of the next, so some warps' boxes are as long as the box
    along the fast axis. In a periodic box they are mostly rows of the
    ghost layers at the two ends, whose sums the owner mirror overwrites;
    the cull treats them as any row with mass. They keep more, and every
    live pair of every row with mass."""
    spec, wd, f, _ = _inputs("turb")
    T = spec.group
    groups, idx, valid, keep = wk.cull_plain(
        wd, spec, f["pos_s"], f["mass_s"], f["h_s"])
    rows = (groups[:, None] * T + torch.arange(T)).reshape(-1, T // 32, 32)
    z = torch.where(f["mass_s"][rows] > 0, f["pos_s"][rows][..., -1],
                    float("nan"))
    span = (torch.nan_to_num(z, nan=-9.0).amax(2)
            - torch.nan_to_num(z, nan=9.0).amin(2))
    straddle = span > 0.5
    assert bool(straddle.any()) and not bool(straddle.all())
    live = _live_pairs(spec, wd, f, groups, idx, valid, "A", None,
                       ghosts=True)
    live = live.reshape(live.shape[0], -1, 32, live.shape[-1])
    lost = (live & ~keep[:, :, None]).sum((2, 3))
    assert int(live.sum((2, 3))[straddle].sum()) > 0
    assert int(lost[straddle].sum()) == 0
    assert (float(keep.sum(2)[straddle].double().mean())
            > float(keep.sum(2)[~straddle & (span > 0)].double().mean()))


def test_a_list_made_for_the_old_h_misses_pairs_after_a_newton_update():
    """newton_update moves h by up to half. At 1.5 h the list culled at h
    lacks live pairs; the list culled at 1.5 h has them all."""
    spec, wd, f, _ = _inputs("turb")
    grown = dict(f, h_s=torch.where(f["mass_s"] > 0, 1.5 * f["h_s"],
                                    f["h_s"]))
    stale, live, _, _ = _missed(spec, wd, grown, "A", h_cull=f["h_s"])
    fresh, _, _, _ = _missed(spec, wd, grown, "A")
    assert live > 0 and stale > 0 and fresh == 0, (stale, fresh, live)


def _over_survivors(monkeypatch, spec, groups, idx, keep):
    """Make the plain versions sum over each warp's survivors only: every
    group's rows are handed to the plain kernel warp by warp, each with
    the pair weight zeroed on the candidate rows its cull dropped. (By
    row, not by column: the plain pass and the kernels' walk may count a
    row that two windows hold at different columns.)"""
    real_pass = wengine._tile_pass
    nw = spec.group // 32
    # dropped entries write to a spare slot, so a row that a later window
    # repeats (invalid there) stays kept
    by_row = torch.zeros(keep.shape[:2] + (spec.n_sorted + 1,),
                         dtype=torch.bool)
    by_row.scatter_(2, torch.where(keep, idx[:, None], spec.n_sorted), keep)

    def tile_pass(kernel_fn, wd, spec_, own_fields, win_fields,
                  mass_axis=None):
        at = [0]
        pos_s = win_fields[0]

        def per_warp(own, winf):
            tb, T = own[0].shape[:2]
            g = slice(at[0], at[0] + tb)
            at[0] += tb
            # the sorted row behind each window column, from its position
            cols = _columns(wd, spec_, groups[g])
            assert torch.equal(pos_s[cols], winf[0])
            k = by_row[g].gather(2, cols[:, None].expand(tb, nw, -1))
            own_w = tuple(o.reshape((tb * nw, 32) + o.shape[2:]) for o in own)
            win_w = [w.repeat_interleave(nw, 0) for w in winf]
            win_w[mass_axis] = torch.where(k.reshape(tb * nw, -1),
                                           win_w[mass_axis], 0.0)
            outs = kernel_fn(own_w, tuple(win_w))
            return tuple(o.reshape((tb, T) + o.shape[2:]) for o in outs)

        return real_pass(per_warp, wd, spec_, own_fields, win_fields,
                         mass_axis=mass_axis)

    monkeypatch.setattr(wengine, "_tile_pass", tile_pass)


def _columns(wd, spec, groups):
    """The sorted row at each column of ``_tile_pass``'s windows."""
    if spec.cwidth > 0:
        return win.compact_index(wd, spec, groups).long()
    ar = torch.arange(spec.wseg, dtype=torch.int64)
    return (wd.w_lo[groups][..., None].long() + ar).reshape(groups.numel(),
                                                            -1)


@pytest.mark.parametrize("name,compact,kind", [
    ("turb", False, "A"), ("turb", True, "A"), ("turb", False, "C"),
    ("turb", True, "C"), ("turb", False, "grav"), ("kh", False, "A"),
    ("kh", True, "C"), ("line", False, "C"),
])
def test_sums_over_survivors_equal_the_full_sums(monkeypatch, name, compact,
                                                 kind):
    spec, wd, f, dom = _inputs(name, compact)
    dim = spec.dim
    base = {3: configs.TURB, 2: configs.KH}.get(dim) or configs.SPHConfig(
        dim=1, gamma=1.4, adaptive_h=True, grad_h=True, balsara=True)
    if kind == "A":
        # one walk at h0, as under h_predict; (d) is the case of more
        cfg = dataclasses.replace(base, adaptive_h=True, h_predict=True)
        run = lambda: wk.solve_h_density_plain(
            wd, spec, *(f[k] for k in A_ARGS), cfg, vel_s=f["vel_s"])
    else:
        cfg, grav = base, None
        if kind == "grav":
            cfg = dataclasses.replace(base, gravity=True, grav_solver="p3m",
                                      G=1.3, grav_eps=0.01, grav_mesh=16)
            grav = (pm.rs_traced(cfg, dom, F64, cutoff=spec.cutoff),
                    cfg.grav_eps)
        run = lambda: wk.forces_plain(wd, spec, *(f[k] for k in C_ARGS), cfg,
                                      grav=grav)
    full = run()
    groups, idx, _, keep = wk.cull_plain(
        wd, spec, f["pos_s"], f["mass_s"], f["h_s"], pair_h=kind != "A",
        rcut=_rcut(spec, kind))
    _over_survivors(monkeypatch, spec, groups, idx, keep)
    culled = run()
    real = wd.is_real
    for a, b in zip(culled, full):
        scale = float(b[real].abs().max())
        assert scale > 0
        torch.testing.assert_close(a[real], b[real], rtol=1e-12,
                                   atol=1e-12 * scale)


def test_margins_equal_the_kernel_source():
    """``cull_plain``'s margins are the constants of ``Margin`` in
    csrc/window_kernels.cu, so what it counts is what the kernels stage."""
    src = (Path(wk.__file__).resolve().parent.parent / "csrc"
           / "window_kernels.cu").read_text()
    body = re.search(r"struct Margin \{(.*?)\};", src, re.S).group(1)
    margin = {k: float(v) for k, v in re.findall(
        r"static constexpr T (\w+) = T\(([0-9.eE+-]+)\);", body)}
    assert set(margin) == {"reach", "reach2", "rcut2", "support2"}
    assert margin["reach"] == wk.CULL_REACH
    assert margin["reach2"] == wk.CULL_REACH2_J
    assert margin["rcut2"] == wk.CULL_RCUT2
    assert margin["reach2"] == pytest.approx(margin["reach"] ** 2, rel=1e-12)
    assert margin["rcut2"] == pytest.approx((margin["reach"] / 2) ** 2,
                                            rel=1e-12)
    # the walk's first test leaves no pair the exact test q < 2 would take,
    # and none the cull's reach would not have kept
    assert 4.0 < margin["support2"] < margin["reach2"]


@pytest.mark.parametrize("name", ["turb", "kh", "line", "sedov",
                                  "sedov_open"])
def test_in_place_ranges_rise_with_the_segment(name):
    """The kernels' contract on the in-place tables: a group's non-empty
    ranges start in rising order, on the build's tables and on masked ones,
    so a row's first occurrence is the part of each range at or above the
    largest end before it."""
    spec, wd, f, _ = _inputs(name)
    act = (f["pos_s"] - 0.5).norm(dim=-1) < 0.3
    for w in (wd, rungs.mask_structure(wd, spec, act)):
        lo = w.w_lo.long()
        hi = lo + 128 * w.w_nact.long()
        full = w.w_nact > 0
        assert bool(full.any())
        # the largest start among the earlier non-empty ranges
        before = torch.cummax(torch.where(full, lo, -1), 1).values
        before = torch.cat([torch.full_like(lo[:, :1], -1), before[:, :-1]],
                           1)
        assert bool((lo >= before)[full].all())
        # the clip equals the range-by-range first-occurrence test
        groups = torch.nonzero(wk._group_active(w, spec)).reshape(-1)
        idx, valid = wk.candidate_table(w, spec, groups)
        end = torch.cummax(torch.where(full, hi, 0), 1).values
        clip = torch.cat([torch.zeros_like(hi[:, :1]), end[:, :-1]], 1)
        k = idx.reshape(groups.numel(), spec.n_seg, spec.wseg)
        by_clip = ((k >= torch.maximum(lo, clip)[groups][..., None])
                   & (k < hi[groups][..., None]))
        assert torch.equal(by_clip.reshape(valid.shape), valid)


# ---------------------------------------------------------------------------
# kernel A's two walks: their steps and lane fill (``walk_counts``)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name,compact", [
    ("turb", False), ("turb", True), ("kh", False), ("kh", True),
    ("sedov", False), ("sedov_open", False), ("line", True),
])
def test_walk_fill_never_exceeds_one(name, compact, masked):
    """On built and ``mask_structure``d tables: every warp's useful pairs
    fit in 32 lanes times the steps of either walk, the pair walk never
    runs the pair arithmetic more often than the walk in which every
    lane visits every survivor, and at the fp32 batch it fills more of the
    lanes."""
    spec, wd, f, _ = _inputs(name, compact)
    if masked:
        wd = rungs.mask_structure(wd, spec,
                                  (f["pos_s"] - 0.5).norm(dim=-1) < 0.3)
    args = (wd, spec, f["pos_s"], f["mass_s"], f["h_s"],
            wk.pair_cap(torch.float32))
    warps = 0
    for c in wk.walk_counts(*args):
        assert bool((c["useful"] <= 32 * c["steps_pairs"]).all())
        assert bool((c["steps_pairs"] <= c["steps_warp"]).all())
        assert bool((c["pairs"] <= c["survivors"]).all())
        assert bool((c["survivors"] <= c["candidates"]).all())
        warps += int(c["live"].sum())
    s = wk.walk_stats(*args)
    assert warps > 0 and s["pairs"] > 0
    assert 0.0 < s["fill_warp"] < s["fill_pairs"] <= 1.0, s
    assert s["pairs_warp"] == pytest.approx(
        s["fill_pairs"] * 32 * s["steps_pairs"])


def _pair_steps_by_loop(wd, spec, f, group, cap, kind="A", rcut=None):
    """The steps of kernel A's pair walk (``kind`` "C": kernel C's, with
    ``rcut`` its gravity mode's) for each warp of ``group``, by a loop that
    follows ``cull_and_stage`` and ``test_and_walk`` in
    csrc/window_kernels.cu: 32 candidates a step from each segment's
    range, a batch walked whenever more than ``cap`` - 32 survivors are
    staged before a step, and for each batch the most survivors that one
    of the warp's rows with mass takes, walked ``PAIR_STEP`` (C:
    ``FORCE_STEP``) a step."""
    c_rule = kind == "C"
    step = wk.FORCE_STEP if c_rule else wk.PAIR_STEP
    T = spec.group
    pos, m, h = f["pos_s"], f["mass_s"], f["h_s"]
    lo_t, n_t = (wd.c_lo, wd.c_len) if spec.cwidth else (wd.w_lo, wd.w_nact)
    ranges, count, max_hi = [], 0, 0
    for s in range(spec.n_seg):
        lo, n = int(lo_t[group, s]), int(n_t[group, s])
        if spec.cwidth:
            ln = min(n, spec.cwidth - count)
            ranges.append((lo, lo + ln))
        else:
            ln = 128 * n
            ranges.append((max(lo, max_hi), lo + ln))
            if ln > 0:
                max_hi = max(max_hi, lo + ln)
        count += ln
    steps = []
    for w in range(T // 32):
        rows = torch.arange(group * T + 32 * w, group * T + 32 * w + 32)
        has = m[rows] > 0
        if not bool(has.any()):
            steps.append(0)
            continue
        x = pos[rows][has]
        reach = wk.CULL_REACH * float(h[rows][has].max())
        batches, held = [[]], 0
        for lo, hi in ranges:
            for k0 in range(lo, hi, 32):
                if held > cap - 32:
                    batches.append([])
                    held = 0
                for k in range(k0, min(k0 + 32, hi)):
                    gap = torch.clamp_min(torch.maximum(
                        x.amin(0) - pos[k], pos[k] - x.amax(0)), 0.0)
                    g2 = float((gap * gap).sum())
                    near = g2 < reach ** 2
                    if c_rule:
                        near |= g2 / float(h[k]) ** 2 < wk.CULL_REACH2_J
                        if rcut is not None:
                            near |= g2 <= rcut ** 2 * wk.CULL_RCUT2
                    if m[k] > 0 and near:
                        batches[-1].append(k)
                        held += 1
        total = 0
        for b in batches:
            if not b:
                continue
            r2 = ((pos[rows][:, None] - pos[b][None]) ** 2).sum(-1)
            takes = r2 * (1.0 / h[rows][:, None]) ** 2 < 4.0001
            if c_rule:
                takes |= r2 * (1.0 / h[b][None]) ** 2 < 4.0001
                if rcut is not None:
                    takes |= r2 <= rcut ** 2
            most = int((takes & has[:, None]).sum(1).max())
            total += step * -(-most // step)
        steps.append(total)
    return steps


@pytest.mark.parametrize("name,compact,cap", [
    ("turb", False, 128), ("turb", True, 64), ("kh", False, 64),
    ("sedov_open", False, 512), ("line", False, 64),
])
def test_pair_walk_steps_follow_the_kernels_loop(name, compact, cap):
    """``walk_counts``' steps of the pair walk, per warp, equal those of a
    loop over the kernels' cull, batches and per-row tests, on groups at
    the start, the middle and the end of the active ones (small ``cap``s
    give several batches a walk)."""
    spec, wd, f, _ = _inputs(name, compact)
    gids = torch.nonzero(wk._group_active(wd, spec)).reshape(-1)
    want, got = [], []
    blocks = list(wk.walk_counts(wd, spec, f["pos_s"], f["mass_s"],
                                 f["h_s"], cap))
    per_warp = torch.cat([b["steps_pairs"] for b in blocks])
    for j in (0, gids.numel() // 2, gids.numel() - 1):
        want.append(_pair_steps_by_loop(wd, spec, f, int(gids[j]), cap))
        got.append(per_warp[j].tolist())
    assert got == want
    assert max(max(w) for w in want) > 0


def test_pair_walk_constants_equal_the_kernel_source():
    """``PAIR_CAP_BYTES`` and ``PAIR_STEP`` are ``PairCap`` and
    ``PAIR_STEP`` in csrc/window_kernels.cu, so what ``walk_stats`` counts
    at ``pair_cap`` is the kernel's batch and step; and every kernel A it
    launches is a pair walk."""
    src = (Path(wk.__file__).resolve().parent.parent / "csrc"
           / "window_kernels.cu").read_text()
    caps = tuple(int(re.search(
        rf"static constexpr int {k} = (\d+) / int\(sizeof\(T\)\);",
        src).group(1)) for k in ("plain", "with_rest"))
    assert caps == wk.PAIR_CAP_BYTES
    step = re.search(r"constexpr int PAIR_STEP = (\d+);", src)
    assert step and int(step.group(1)) == wk.PAIR_STEP
    for dtype in (torch.float32, torch.float64):
        assert wk.pair_cap(dtype) % 32 == 0
        assert wk.pair_cap(dtype, with_rest=True) % 32 == 0
    launched = set(re.findall(r"run\((solve_h_density\w*)<", src))
    assert launched == {"solve_h_density_pairs_kernel",
                        "solve_h_density_pairs_compact_kernel"}


# ---------------------------------------------------------------------------
# kernel C's two walks (``walk_counts`` with C's rule)
# ---------------------------------------------------------------------------


def _c_walk(spec, kind):
    """``walk_counts``' arguments for kernel C's rule (``kind`` "grav": its
    gravity mode) beside the table and fields."""
    return dict(pair_h=True, rcut=_rcut(spec, kind), step=wk.FORCE_STEP)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name,compact,kind", [
    ("turb", False, "C"), ("turb", True, "C"), ("turb", False, "grav"),
    ("kh", False, "C"), ("kh", True, "C"), ("sedov", False, "C"),
    ("sedov_open", False, "C"), ("line", True, "C"),
])
def test_force_walk_fill_never_exceeds_one(name, compact, kind, masked):
    """Kernel C's rule on built and ``mask_structure``d tables: every
    warp's useful pairs (inside 2 max(h_i, h_j) of a row with mass, or
    the cutoff) fit in 32 lanes times the steps of either walk, the pair
    walk never runs the pair arithmetic more often than the walk in which
    every lane visits every survivor, and at C's fp32 batch it fills more
    of the lanes."""
    spec, wd, f, _ = _inputs(name, compact)
    if masked:
        wd = rungs.mask_structure(wd, spec,
                                  (f["pos_s"] - 0.5).norm(dim=-1) < 0.3)
    args = (wd, spec, f["pos_s"], f["mass_s"], f["h_s"],
            wk.force_cap(torch.float32))
    walk = _c_walk(spec, kind)
    warps = 0
    for c in wk.walk_counts(*args, **walk):
        assert bool((c["useful"] <= 32 * c["steps_pairs"]).all())
        assert bool((c["steps_pairs"] <= c["steps_warp"]).all())
        assert bool((c["pairs"] <= c["survivors"]).all())
        assert bool((c["survivors"] <= c["candidates"]).all())
        warps += int(c["live"].sum())
    s = wk.walk_stats(*args, **walk)
    a = wk.walk_stats(*args)
    assert warps > 0 and s["pairs"] >= a["pairs"] > 0
    assert 0.0 < s["fill_warp"] < s["fill_pairs"] <= 1.0, s
    assert s["pairs_warp"] == pytest.approx(
        s["fill_pairs"] * 32 * s["steps_pairs"])


@pytest.mark.parametrize("name,compact,kind,cap", [
    ("turb", False, "C", 64), ("turb", True, "grav", 64),
    ("kh", False, "C", 64), ("sedov_open", False, "C", 128),
    ("line", False, "C", 32),
])
def test_force_walk_steps_follow_the_kernels_loop(name, compact, kind, cap):
    """``walk_counts``' steps of kernel C's pair walk, per warp, equal those
    of a loop over C's cull (reach 2 max(h_max, h_j), at least the cutoff
    in its gravity mode), batches and per-row tests (r^2 / h_i^2 or r^2 /
    h_j^2 against 4.0001, or inside the cutoff), on groups at the start,
    the middle and the end of the active ones."""
    spec, wd, f, _ = _inputs(name, compact)
    rcut = _rcut(spec, kind)
    gids = torch.nonzero(wk._group_active(wd, spec)).reshape(-1)
    want, got = [], []
    blocks = list(wk.walk_counts(wd, spec, f["pos_s"], f["mass_s"],
                                 f["h_s"], cap, **_c_walk(spec, kind)))
    per_warp = torch.cat([b["steps_pairs"] for b in blocks])
    for j in (0, gids.numel() // 2, gids.numel() - 1):
        want.append(_pair_steps_by_loop(wd, spec, f, int(gids[j]), cap, "C",
                                        rcut))
        got.append(per_warp[j].tolist())
    assert got == want
    assert max(max(w) for w in want) > 0


def test_force_walk_constants_equal_the_kernel_source():
    """``FORCE_CAP`` and ``FORCE_STEP`` are ``ForceCap`` and ``FORCE_STEP``
    in csrc/window_kernels.cu, so what ``walk_stats`` counts at
    ``force_cap`` is kernel C's batch and step; a batch is whole words of
    the mask; and kernel C launches its pair walk outside the GRAV mode
    and the walk in which every lane visits every survivor in it."""
    src = (Path(wk.__file__).resolve().parent.parent / "csrc"
           / "window_kernels.cu").read_text()
    cap = re.search(r"static constexpr int n = sizeof\(T\) == 4 \? (\d+) : "
                    r"(\d+);", src)
    assert cap and (int(cap.group(1)), int(cap.group(2))) == wk.FORCE_CAP
    step = re.search(r"constexpr int FORCE_STEP = (\d+);", src)
    assert step and int(step.group(1)) == wk.FORCE_STEP
    for dtype in (torch.float32, torch.float64):
        assert wk.force_cap(dtype) % 32 == 0
    launched = set(re.findall(r"run\((forces\w*)<", src))
    assert launched == {"forces_pairs_kernel", "forces_pairs_compact_kernel",
                        "forces_kernel", "forces_compact_kernel"}
    grav = re.search(r"if constexpr \(COMPACT && GRAV\)\s+run\((\w+)<.*?"
                     r"else if constexpr \(COMPACT\)\s+run\((\w+)<.*?"
                     r"else if constexpr \(GRAV\)\s+run\((\w+)<.*?"
                     r"else\s+run\((\w+)<", src, re.S)
    assert grav and grav.groups() == (
        "forces_compact_kernel", "forces_pairs_compact_kernel",
        "forces_kernel", "forces_pairs_kernel")
