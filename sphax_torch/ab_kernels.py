"""Kernels A and C built from two source trees, timed in one process on one
card.

    python -m sphax_torch.ab_kernels OTHER_CSRC [ROUNDS]

OTHER_CSRC is another version's ``sphax_torch/csrc`` (for example a parent
commit unpacked with ``git archive`` into a directory that ``.gitignore``
lists). Both trees are built. Every instantiation of the kernels then runs
on the same sorted inputs, in place and compact (``with_cwidth``): in 3D at
N = 1e6, A (h_predict and cold) and C (fast_math) at the bench
configuration's shapes, and C exact with and without the P3M gravity mode at
the P3M path's shapes (``chip_smoke.py`` phases 8 and 13); in 2D, A (cold)
and C (exact) at the ``kh n=1024`` shapes (phase 18); A (cold, 6 Newton
updates) and C (exact) on the ``sedov n=100`` structure, unmasked, masked
with a tenth of the particles closing and masked down to 4 active groups
(phases 22 and 24); in 1D, A (cold) and C (exact) on a line of 2^20
particles (phase 26). The versions take turns in the order this, other,
other, this, for ROUNDS rounds (default 3); each time is CUDA events over 10
launches. Prints what ptxas reports for both builds, the kernels present in
both whose registers differ, what ``torch.profiler`` records for one launch
of A and of C from this tree at the bench shapes (the kernel's name and
device time) beside what the CUDA runtime reports of that very launch
(``sphax_last_launch``: registers, shared and local memory, and the blocks a
SM holds at once), and one JSON line with each version's median ms per
case. The machine's counters (scheduler slots, stall reasons, achieved
occupancy) need Nsight Compute, which this script does not drive.
"""
from __future__ import annotations

import ctypes
import dataclasses
import json
import math
import re
import statistics
import sys
from pathlib import Path

import torch

from sphax_torch import _build, bench, configs, make_state, problems
from sphax_torch.core.state import box
from sphax_torch.ics import lattice
from sphax_torch.integrate import rungs
from sphax_torch.neighbors import window as win
from sphax_torch.physics import pm, wengine
from sphax_torch.physics import window_kernels as wk

BASES = tuple(k for k in _build._ARGTYPES if k != "sphax_gravity")


def registers(ptxas: str) -> dict:
    """Kernel name -> registers per thread, from ptxas's -v output. The
    anonymous namespace's mangled name carries a hash of the source, which
    is dropped so that two versions' kernels compare by name."""
    out, name = {}, None
    for line in ptxas.splitlines():
        m = re.search(r"entry function '(\S+)'", line)
        if m:
            name = re.sub(r"_GLOBAL__N__[0-9a-f]{8}_\d+_(\w+?_cu)_[0-9a-f]{8}",
                          r"_GLOBAL__N_\1_", m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = int(m.group(1))
            name = None
    return out


def sorted_fields(st, wd):
    """The kernels' sorted inputs for the state ``st``."""
    d = st.dim
    c = torch.cat([st.pos, st.vel, st.mass[:, None], st.h[:, None],
                   st.rho[:, None], st.P[:, None], st.cs[:, None],
                   st.omega[:, None]], dim=-1)
    g = win.gather_sorted_cols(c, wd, [0.0] * (2 * d) + [0.0] + [1.0] * 5)
    m = 2 * d
    f = dict(pos_s=wd.pos_s, vel_s=g[:, d:m], mass_s=g[:, m],
             h0_s=g[:, m + 1], h_s=g[:, m + 1], rho_s=g[:, m + 2],
             P_s=g[:, m + 3], cs_s=g[:, m + 4], om_s=g[:, m + 5],
             bf_s=torch.ones_like(g[:, m + 5]))
    return {k: v.contiguous() for k, v in f.items()}


def with_cwidth(spec, pos, dom):
    """``spec`` with ``window.plan_compact``'s width for these positions
    (its probe build at cwidth 128): the same sort and windows, so the same
    sorted inputs serve the in-place and the compact walk."""
    probe = win.build(pos, dom, dataclasses.replace(spec, cwidth=128))
    cw = int(math.ceil(int(probe.c_max) * 1.2 / 128) * 128)
    return dataclasses.replace(spec, cwidth=max(cw, 128))


def sedov_inputs(dev, jitter_seed=7):
    """The ``sedov n=100`` structure on positions jittered by a seeded 0.2
    of a spacing with a seeded 0.4 N(0,1) velocity (on the resting lattice
    d rho/d h cancels and the Balsara sums vanish), and two masks of it:
    the ball around the blast centre that holds a tenth of the box closing,
    and 4 row-groups at the centre. Returns (problem, jittered state, wd,
    sorted fields, closing particles [N], {name: masked wd})."""
    prob = problems.sedov(n=100, device=dev)
    st, dom, spec = prob.state, prob.domain, prob.wspec
    n_side = round(st.n ** (1 / 3))
    gen = torch.Generator(device=dev).manual_seed(jitter_seed)
    st_j = st._replace(pos=dom.wrap(st.pos + (0.2 / n_side) * (
        2.0 * torch.rand(st.pos.shape, generator=gen, device=dev) - 1.0)))
    wd = win.build(st_j.pos, dom, spec)
    f = sorted_fields(st_j, wd)
    f["vel_s"] = win.gather_sorted(0.4 * torch.randn(
        st.vel.shape, generator=gen, device=dev), wd)
    r_ball = (0.1 * 3.0 / (4.0 * math.pi)) ** (1.0 / 3.0)
    close = (st_j.pos - 0.5).norm(dim=-1) < r_ball
    act_rows = win.gather_sorted(close.to(st.pos.dtype), wd) > 0.5
    # the row-group of the real row nearest the centre and the 3 after it
    d2 = torch.where(wd.is_real, (wd.pos_s - 0.5).pow(2).sum(-1), 9.0)
    g0 = min(int(d2.argmin()) // spec.group, spec.n_groups - 4)
    few = torch.zeros_like(act_rows)
    few[g0 * spec.group:(g0 + 4) * spec.group] = True
    masks = {"tenth": rungs.mask_structure(wd, spec, act_rows),
             "4 groups": rungs.mask_structure(wd, spec, few)}
    return prob, st_j, wd, f, close, masks


def line_inputs(dev, n=1 << 20):
    """A periodic line of ``n`` particles (a lattice jittered by 0.2
    spacings, seeded velocity noise) with the CLI's window knobs. Returns
    (state, cfg, domain, spec)."""
    cfg = configs.SPHConfig(dim=1, gamma=1.4, adaptive_h=True, grad_h=True,
                            balsara=True, newton_iters=2)
    gen = torch.Generator(device=dev).manual_seed(6)
    st = make_state(
        torch.as_tensor(lattice.cubic_lattice((n,), [0.0], [1.0]),
                        dtype=torch.float32, device=dev)
        + (0.2 / n) * (2.0 * torch.rand((n, 1), generator=gen, device=dev)
                       - 1.0),
        0.1 * torch.randn((n, 1), generator=gen, device=dev),
        torch.full((n,), 1.0 / n, device=dev), torch.ones(n, device=dev),
        torch.full((n,), cfg.eta / n, device=dev))
    dom = box(torch.zeros(1, device=dev), torch.ones(1, device=dev))
    spec = win.plan_measured(st.pos, dom, h_max=float(st.h.max()) * 1.3,
                             dim=1, cutoff_scale=1.25, fast_sub=3, rgroups=2)
    return st, cfg, dom, spec


def _cases(dev):
    """name -> a function that launches one kernel on fixed inputs."""
    a_args = ("pos_s", "mass_s", "h0_s")
    c_args = ("pos_s", "vel_s", "mass_s", "h_s", "rho_s", "P_s", "cs_s",
              "om_s", "bf_s")
    cases = {}

    def a(fields, w, s, cfg):
        return lambda: wk.solve_h_density(w, s, *(fields[k] for k in a_args),
                                          cfg, vel_s=fields["vel_s"])

    def c(fields, w, s, cfg, gr=None):
        return lambda: wk.forces(w, s, *(fields[k] for k in c_args), cfg,
                                 grav=gr)

    def both_walks(pos, dom, spec, add):
        """``add(tag, wd, spec)`` for the in-place and the compact walk."""
        wd = win.build(pos, dom, spec)
        add("", wd, spec)
        spec_c = with_cwidth(spec, pos, dom)
        add(" compact", win.build(pos, dom, spec_c), spec_c)
        return wd

    hp = dataclasses.replace(configs.TURB, newton_iters=1, fast_math=True,
                             h_predict=True)
    cold = dataclasses.replace(configs.TURB, newton_iters=1)
    st, dom, spec = bench.setup(100, hp, dev, h_margin=1.05,
                                cutoff_scale=1.05, ghost_safety=1.4,
                                fast_sub=3, rgroups=2)
    f = sorted_fields(st, win.build(st.pos, dom, spec))

    def bench_cases(tag, w, s):
        cases[f"A h_predict{tag}"] = a(f, w, s, hp)
        cases[f"A cold{tag}"] = a(f, w, s, cold)
        cases[f"C fast_math{tag}"] = c(f, w, s, hp)
    both_walks(st.pos, dom, spec, bench_cases)

    cfg_g = dataclasses.replace(configs.TURB, newton_iters=2, gravity=True,
                                grav_solver="p3m", grav_mesh=128)
    st_g, dom_g, spec_g = bench.setup(100, cfg_g, dev, vel_scale=0.0,
                                      h_margin=1.3, cutoff_scale=1.25,
                                      fast_sub=3, rgroups=2)
    fg = sorted_fields(st_g, win.build(st_g.pos, dom_g, spec_g))
    grav = (pm.rs_traced(cfg_g, dom_g, torch.float32, cutoff=spec_g.cutoff),
            cfg_g.grav_eps)

    def p3m_cases(tag, w, s):
        cases[f"C grav{tag}"] = c(fg, w, s, cfg_g, grav)
        cases[f"C exact{tag}"] = c(fg, w, s, cfg_g)
    both_walks(st_g.pos, dom_g, spec_g, p3m_cases)

    kh = problems.kh(n=1024, device=dev)
    f2 = sorted_fields(kh.state, win.build(kh.state.pos, kh.domain, kh.wspec))

    def kh_cases(tag, w, s):
        cases[f"A2 cold{tag}"] = a(f2, w, s, kh.cfg)
        cases[f"C2 exact{tag}"] = c(f2, w, s, kh.cfg)
    both_walks(kh.state.pos, kh.domain, kh.wspec, kh_cases)

    prob_s, _, wd_s, fs, _, masks = sedov_inputs(dev)
    for tag, w in (("", wd_s), *((f" masked {k}", v)
                                 for k, v in masks.items())):
        cases[f"A sedov{tag}"] = a(fs, w, prob_s.wspec, prob_s.cfg)
        cases[f"C sedov{tag}"] = c(fs, w, prob_s.wspec, prob_s.cfg)

    st1, cfg1, dom1, spec1 = line_inputs(dev)
    st1 = wengine.update_derived(st1, cfg1, dom1, spec1)
    f1 = sorted_fields(st1, win.build(st1.pos, dom1, spec1))

    def line_cases(tag, w, s):
        cases[f"A1 cold{tag}"] = a(f1, w, s, cfg1)
        cases[f"C1 exact{tag}"] = c(f1, w, s, cfg1)
    both_walks(st1.pos, dom1, spec1, line_cases)
    return cases


def _ms(fn, reps=10):
    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def last_launch(lib) -> dict:
    """What the CUDA runtime reports of the kernel A or C that ``lib``
    launched last (``cudaFuncGetAttributes`` and
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` at the launch's block
    size and dynamic shared memory)."""
    out = (ctypes.c_int * 6)()
    lib.sphax_last_launch.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.sphax_last_launch.restype = ctypes.c_int
    err = lib.sphax_last_launch(out)
    if err != 0:
        raise RuntimeError("sphax_last_launch failed: "
                           + lib.sphax_error_string(err).decode())
    regs, static, dynamic, local, threads, blocks = out
    return {"registers": regs, "static_smem_bytes": static,
            "dynamic_smem_bytes": dynamic, "local_bytes": local,
            "threads_per_block": threads, "blocks_per_sm": blocks,
            "warps_per_sm": blocks * threads // 32}


def profile(cases, lib, names=("A h_predict", "C fast_math")) -> dict:
    """One profiled launch of each of ``names``: the CUDA kernel's name and
    device microseconds from ``torch.profiler``, and ``last_launch`` of
    it."""
    out = {}
    for name in names:
        cases[name]()
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            cases[name]()
            torch.cuda.synchronize()
        rec = last_launch(lib)
        ev = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and ("solve_h_density" in e.name or "forces" in e.name)]
        if ev:
            rec.update(kernel=ev[0].name[:100],
                       device_us=ev[0].time_range.elapsed_us())
        else:
            rec.update(kernel="the profiler recorded no kernel")
        out[name] = rec
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("sphax_torch.ab_kernels needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    other = Path(argv[0])
    rounds = int(argv[1]) if len(argv) > 1 else 3
    libs, regs = {}, {}
    for tag, sources in (("this", _build.SOURCES),
                         ("other", tuple(other / s.name
                                         for s in _build.SOURCES))):
        # built afresh, so that ptxas reports on both
        _build.library_path(sources).unlink(missing_ok=True)
        _build.BUILD_INFO.update(ptxas="")
        libs[tag] = _build.open_library(_build.build(sources), BASES)
        regs[tag] = registers(_build.BUILD_INFO["ptxas"])
    for tag in regs:
        for name, n in sorted(regs[tag].items()):
            print(f"{tag:5s} {n:4d} registers  {name}")
    both = sorted(set(regs["this"]) & set(regs["other"]))
    moved = [k for k in both if regs["this"][k] != regs["other"][k]]
    print(f"{len(both)} kernels in both builds; registers differ in "
          f"{len(moved)}: {moved}")
    cases = _cases(torch.device("cuda"))
    times = {tag: {name: [] for name in cases} for tag in libs}
    try:
        for _ in range(rounds):
            for tag in ("this", "other", "other", "this"):
                _build._lib = libs[tag]
                for name, fn in cases.items():
                    times[tag][name].append(_ms(fn))
    finally:
        _build._lib = None
    _build._lib = libs["this"]
    try:
        prof = profile(cases, libs["this"])
    finally:
        _build._lib = None
    for name, rec in prof.items():
        print(f"profile {name}: {rec}")
    print(json.dumps({
        "card": bench.card(), "rounds": rounds, "profile": prof,
        "registers_differ": moved,
        "median_ms": {tag: {k: statistics.median(v) for k, v in t.items()}
                      for tag, t in times.items()},
        "ms": times}))


if __name__ == "__main__":
    main()
