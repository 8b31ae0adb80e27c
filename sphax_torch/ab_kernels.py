"""Kernels A, C and G built from two source trees, timed in one process on
one card.

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
particles (phase 26); A and C at the benchmark's ``turb256`` and
``sedov128`` shapes (``problems.turb(n=256, accel_rms=0.2)`` and
``problems.sedov(n=128)``, the set-up states). Kernel G runs on seeded
uniform clouds, fp32 at
N = 4,096, 20,000, 65,536, 64^3 and 1e6 and fp64 at 64^3, through its
planned C signature (a tree older than G's redesign, whose G took a [4, N]
pack and no plan, does not load).
The versions take turns in the order this, other, other, this, for ROUNDS
rounds (default 3); each time is CUDA events over 10 launches (2 for G at
N = 1e6, 5 for G in fp64). Prints what ptxas reports for both builds, the
kernels present in both whose registers differ, what ``torch.profiler``
records for one launch of A and C (at the bench shapes, A and C at
turb256's, C at sedov128's and in 2D) and G (at N = 4,096, 20,000 and 64^3)
from this tree (the kernel's name and device time) beside what the CUDA runtime
reports of that very launch (``sphax_last_launch``,
``sphax_gravity_last_launch``: registers, shared and local memory, and the
blocks a SM holds at once). For G it also times this tree's kernel under
other plans (``g_plans``: from one slice to one tile a slice), by events
and by its kernels' device time,
and counts the instructions of each G kernel's inner loop in
``cuobjdump -sass`` of both builds (per pair: the
smallest loop that holds a reciprocal square root, over the pairs it
holds), with the floor that count sets at the card's top SM clock: a
computed time, not a measured one; and the SM clock and board power that
``nvidia-smi`` samples while G runs at N = 1e6. The last line is one JSON
record with each version's median ms per case. The machine's counters
(scheduler slots, stall reasons, achieved occupancy) need Nsight Compute,
which this script does not drive.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from sphax_torch import _build, bench, configs, make_state, problems
from sphax_torch.bounds import gravity_bound
from sphax_torch.core.state import box
from sphax_torch.ics import lattice
from sphax_torch.integrate import rungs
from sphax_torch.neighbors import window as win
from sphax_torch.physics import direct_gravity as dg
from sphax_torch.physics import pm, wengine
from sphax_torch.physics import window_kernels as wk

G_CFG = configs.SPHConfig(gravity=True, G=1.4, grav_eps=0.03)
# (N, dtype, launches a time)
G_SHAPES = ((4096, torch.float32, 10), (20000, torch.float32, 10),
            (65536, torch.float32, 10), (64 ** 3, torch.float32, 10),
            (64 ** 3, torch.float64, 5), (10 ** 6, torch.float32, 2))
# the sizes at which g_sweep times other plans beside gravity_plan's
G_SWEEP_N = (4096, 10000, 20000, 32768, 65536, 64 ** 3, 10 ** 6)


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


def cloud(dev, n, dtype, seed=3):
    """N seeded uniform positions in the unit cube and masses (0.5 to 1.5)
    / N, as ``chip_smoke.py`` phase 10 makes them."""
    g = torch.Generator(device=dev).manual_seed(seed)
    pos = torch.rand((n, 3), generator=g, dtype=dtype, device=dev)
    return pos, (torch.rand(n, generator=g, dtype=dtype, device=dev)
                 + 0.5) / n


def g_cases(dev):
    """name -> (a function that launches kernel G on a fixed cloud, its
    launches a time)."""
    cases = {}
    for n, dtype, reps in G_SHAPES:
        pos, mass = cloud(dev, n, dtype)
        tag = "fp32" if dtype == torch.float32 else "fp64"
        cases[f"G {tag} N={n}"] = (
            lambda p=pos, m=mass: dg.gravity(p, m, G_CFG), reps)
    return cases


def sass_per_pair(lib_path) -> dict:
    """Kernel G's inner loop in ``cuobjdump -sass`` of a built library, per
    kernel instantiation: the instructions of the smallest loop (a backward
    branch and its target) that holds a reciprocal square root
    (``MUFU.RSQ``, ``MUFU.RSQ64H`` in fp64; one a pair), over the pairs it
    holds, in all and by opcode."""
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "-sass", str(lib_path)], check=True,
                         capture_output=True, text=True).stdout
    res = {}
    for func in re.split(r"\n\s*Function : ", out)[1:]:
        name = func.split("\n", 1)[0].strip()
        # the rows a thread, a template argument since the redesign (1 before)
        m = re.search(r"14gravity_kernelI([fd])(?:Li(\d)E)?", name)
        if not m:
            continue
        ops, addr, labels, pending = [], [], {}, []
        for line in func.splitlines():
            lab = re.match(r"\s*(\.L_x_\d+):", line)
            if lab:
                pending.append(lab.group(1))
                continue
            ins = re.search(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                            r"([A-Z][A-Z0-9_.]*)(.*)", line)
            if not ins:
                continue
            a = int(ins.group(1), 16)
            labels.update({k: a for k in pending})
            pending = []
            ops.append((ins.group(2), ins.group(3)))
            addr.append(a)
        loops = []
        for b, (op, rest) in enumerate(ops):
            tgt = re.search(r"\(([.\w]+)\)|(0x[0-9a-f]+)", rest)
            if not op.startswith("BRA") or not tgt:
                continue
            t = (labels.get(tgt.group(1)) if tgt.group(1)
                 else int(tgt.group(2), 16))
            if t is None or t > addr[b] or t not in addr:
                continue
            body = [o for o, _ in ops[addr.index(t):b + 1]]
            pairs = sum(o.startswith("MUFU.RSQ") for o in body)
            if pairs:
                loops.append((len(body), body, pairs))
        if not loops:
            continue
        _, body, pairs = min(loops, key=lambda x: x[0])
        count = collections.Counter(o.split(".")[0] for o in body)
        per = {k: v / pairs for k, v in sorted(count.items())}
        res[f"{'f32' if m.group(1) == 'f' else 'f64'} R={m.group(2) or 1}"] = {
            "pairs_in_loop": pairs, "per_pair": len(body) / pairs,
            "fp32_per_pair": sum(per.get(k, 0) for k in ("FADD", "FMUL",
                                                         "FFMA")),
            "fp64_per_pair": sum(per.get(k, 0) for k in ("DADD", "DMUL",
                                                         "DFMA")),
            "by_opcode": per}
    return res


def max_sm_clock_hz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], check=True,
                         capture_output=True, text=True).stdout
    return float(out.split()[0]) * 1e6


def clocks_during(fn) -> list:
    """(SM MHz, board W) that ``nvidia-smi`` samples every 250 ms while
    ``fn`` runs on the card."""
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "250"],
                           stdout=subprocess.PIPE, text=True)
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        smi.terminate()
    return [tuple(float(x) for x in line.split(","))
            for line in smi.communicate()[0].splitlines()
            if re.fullmatch(r"[\d.]+, *[\d.]+", line.strip())]


def sass_floor_ms(per, n, sm_count, clock_hz) -> dict:
    """The time N^2 pairs take at ``per`` (one ``sass_per_pair`` entry) if
    every SM issues 4 warp-instructions a clock (128 thread-instructions),
    and if the fp32 (128 lanes), fp64 (64) and special-function (16) pipes
    each run at their rate: computed, not measured."""
    pairs = float(n) * n / (sm_count * clock_hz) * 1e3
    by = per["by_opcode"]
    return {"issue": pairs * per["per_pair"] / 128,
            "fp32_pipe": pairs * per["fp32_per_pair"] / 128,
            "fp64_pipe": pairs * per["fp64_per_pair"] / 64,
            "mufu_pipe": pairs * by.get("MUFU", 0) / 16}


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

    # the benchmark cells' shapes: each problem's set-up state
    for tag, prob in (("turb256", problems.turb(n=256, accel_rms=0.2,
                                                device=dev)),
                      ("sedov128", problems.sedov(n=128, device=dev))):
        w = win.build(prob.state.pos, prob.domain, prob.wspec)
        fc = sorted_fields(prob.state, w)
        cases[f"A {tag}"] = a(fc, w, prob.wspec, prob.cfg)
        cases[f"C {tag}"] = c(fc, w, prob.wspec, prob.cfg)

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


def last_launch(lib, entry="sphax_last_launch") -> dict:
    """What the CUDA runtime reports of the kernel A or C (``entry``
    ``sphax_gravity_last_launch``: G) that ``lib`` launched last
    (``cudaFuncGetAttributes`` and
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` at the launch's block
    size and dynamic shared memory)."""
    out = (ctypes.c_int * 6)()
    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    err = fn(out)
    if err != 0:
        raise RuntimeError(f"{entry} failed: "
                           + lib.sphax_error_string(err).decode())
    regs, static, dynamic, local, threads, blocks = out
    return {"registers": regs, "static_smem_bytes": static,
            "dynamic_smem_bytes": dynamic, "local_bytes": local,
            "threads_per_block": threads, "blocks_per_sm": blocks,
            "warps_per_sm": blocks * threads // 32}


def profile(cases, lib, names=("A h_predict", "C fast_math", "A turb256",
                                "C turb256", "C sedov128", "C2 exact",
                                "G fp32 N=4096", "G fp32 N=20000",
                                "G fp32 N=262144")) -> dict:
    """One profiled launch of each of ``names``: the CUDA kernels' names
    and device microseconds from ``torch.profiler`` (G: its main kernel and,
    with slices, the reduction), and ``last_launch`` of it."""
    out = {}
    for name in names:
        g = name.startswith("G")
        cases[name]()
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            cases[name]()
            torch.cuda.synchronize()
        rec = last_launch(lib, "sphax_gravity_last_launch" if g
                          else "sphax_last_launch")
        keys = (("gravity_kernel", "reduce_slices") if g
                else ("solve_h_density", "forces"))
        ev = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and any(k in e.name for k in keys)]
        if ev:
            rec.update(kernel=[e.name[:100] for e in ev],
                       device_us=[e.time_range.elapsed_us() for e in ev])
        else:
            rec.update(kernel="the profiler recorded no kernel")
        out[name] = rec
    return out


def g_plans(n, sm_count) -> dict:
    """name -> kernel G plans at N: ``gravity_plan``'s own, then one slice,
    half the plan's slices, twice as many and one tile a slice (whole
    tiles, as even as tiles allow; a workspace over 1 GiB is left out)."""
    plan = dg.gravity_plan(n, sm_count)
    tiles = -(-n // dg.TILE)
    plans = {"plan": plan}
    for want in (1, plan[2] // 2, 2 * plan[2], tiles):
        per = -(-tiles // min(max(want, 1), tiles))
        slices = -(-tiles // per)
        if slices != plan[2] and (slices == 1
                                  or slices * 3 * n * 4 <= 1 << 30):
            plans[f"slices={slices}"] = (dg.ROWS, dg.THREADS, slices,
                                         per * dg.TILE)
    return plans


def g_device_us(fn, calls) -> float:
    """Device microseconds a call of ``fn`` spends in kernel G's kernels
    (the main one and the slices' reduction), from ``torch.profiler`` over
    ``calls`` calls."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and ("gravity_kernel" in e.name
                    or "reduce_slices" in e.name)) / calls


def g_sweep(dev, rounds=2) -> dict:
    """This tree's kernel G (fp32) at ``G_SWEEP_N`` under each of
    ``g_plans``, in turns: the median ms of CUDA events over 10 launches (2
    at N = 1e6), and the median device ms of its kernels (``g_device_us``
    over the same launches), which at small N is far below the events' time
    because the host's launches take longer than the kernels."""
    sm = dg._sm_count(dev)
    times = {}
    for n in G_SWEEP_N:
        pos, mass = cloud(dev, n, torch.float32)
        plans = g_plans(n, sm)
        reps = 2 if n >= 10 ** 6 else 10
        got = {k: ([], []) for k in plans}
        for _ in range(rounds):
            for k, p in plans.items():
                fn = lambda p=p: dg._launch(pos, mass, G_CFG, p)
                got[k][0].append(_ms(fn, reps))
                got[k][1].append(g_device_us(fn, reps) / 1e3)
        times[n] = {k: {"plan": plans[k], "ms": statistics.median(ev),
                        "device_ms": statistics.median(d)}
                    for k, (ev, d) in got.items()}
    return times


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("sphax_torch.ab_kernels needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    other = Path(argv[0])
    rounds = int(argv[1]) if len(argv) > 1 else 3
    libs, regs, sass = {}, {}, {}
    for tag, sources in (("this", _build.SOURCES),
                         ("other", tuple(other / s.name
                                         for s in _build.SOURCES))):
        # built afresh, so that ptxas reports on both
        _build.library_path(sources).unlink(missing_ok=True)
        _build.BUILD_INFO.update(ptxas="")
        path = _build.build(sources)
        libs[tag] = _build.open_library(path)
        regs[tag] = registers(_build.BUILD_INFO["ptxas"])
        sass[tag] = sass_per_pair(path)
    for tag in regs:
        for name, n in sorted(regs[tag].items()):
            print(f"{tag:5s} {n:4d} registers  {name}")
    both = sorted(set(regs["this"]) & set(regs["other"]))
    moved = [k for k in both if regs["this"][k] != regs["other"][k]]
    print(f"{len(both)} kernels in both builds; registers differ in "
          f"{len(moved)}: {moved}")
    dev = torch.device("cuda")
    cases = {k: (fn, 10) for k, fn in _cases(dev).items()}
    cases.update(g_cases(dev))
    times = {tag: {name: [] for name in cases} for tag in libs}
    try:
        for _ in range(rounds):
            for tag in ("this", "other", "other", "this"):
                _build._lib = libs[tag]
                for name, (fn, reps) in cases.items():
                    times[tag][name].append(_ms(fn, reps))
    finally:
        _build._lib = None
    _build._lib = libs["this"]
    try:
        prof = profile({k: fn for k, (fn, _) in cases.items()},
                       libs["this"])
        sweep = g_sweep(dev)
        g_1e6 = cases["G fp32 N=1000000"][0]
        clocks = clocks_during(lambda: [g_1e6() for _ in range(6)])
    finally:
        _build._lib = None
    for name, rec in prof.items():
        print(f"profile {name}: {rec}")
    for n, rec in sweep.items():
        for k, v in rec.items():
            print(f"G sweep N={n} {k:18s} {v['plan']}: {v['ms']:.4f} ms, "
                  f"device {v['device_ms']:.4f} ms")
    print(f"SM MHz, board W under G at N = 1e6: {clocks}")
    sm, clock = dg._sm_count(dev), max_sm_clock_hz()
    g_keys = {f"{'fp32' if d == torch.float32 else 'fp64'} N={n}": (n, d)
              for n, d, _ in G_SHAPES}
    floors = {}
    for tag, per_kernel in sass.items():
        for k, per in per_kernel.items():
            print(f"{tag:5s} sass {k}: {per['per_pair']:.2f} instructions "
                  f"a pair ({per['fp32_per_pair']:.2f} fp32, "
                  f"{per['fp64_per_pair']:.2f} fp64) {per['by_opcode']}")
            dt = torch.float32 if k.startswith("f32") else torch.float64
            floors[f"{tag} {k}"] = {
                n: sass_floor_ms(per, n, sm, clock)
                for n, d, _ in G_SHAPES if d == dt}
    print(json.dumps({
        "card": bench.card(), "rounds": rounds, "profile": prof,
        "g_plans": {k: dg.gravity_plan(n, sm)
                    for k, (n, d) in g_keys.items()},
        "g_bound_ms": {k: gravity_bound(n, d)[0]
                       for k, (n, d) in g_keys.items()},
        "g_sweep": sweep, "g_sass": sass, "g_sass_floor_ms": floors,
        "sm_count": sm, "max_sm_clock_hz": clock,
        "sm_mhz_board_w_under_g_1e6": clocks,
        "registers_differ": moved,
        "median_ms": {tag: {k: statistics.median(v) for k, v in t.items()}
                      for tag, t in times.items()},
        "ms": times}))


if __name__ == "__main__":
    main()
