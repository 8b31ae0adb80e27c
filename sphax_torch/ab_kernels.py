"""Kernels A and C built from two source trees, timed in one process on one
card.

    python -m sphax_torch.ab_kernels OTHER_CSRC [ROUNDS]

OTHER_CSRC is another version's ``sphax_torch/csrc`` (for example a parent
commit unpacked with ``git archive`` into a directory that ``.gitignore``
lists). Both trees are built. The in-place kernels then run on the same
sorted inputs: in 3D at N = 1e6, A (h_predict and cold) and C (fast_math) at
the bench configuration's shapes, and C exact with and without the P3M
gravity mode at the P3M path's shapes (``chip_smoke.py`` phases 8 and 13);
in 2D, A (cold) and C (exact) at the ``kh n=1024`` shapes (phase 18). The
versions take turns in the order this, other, other, this, for ROUNDS rounds
(default 3); each time is CUDA events over 10 launches. Prints what ptxas
reports for both builds, the kernels present in both whose registers
differ, and one JSON line with each version's median ms per case.
"""
from __future__ import annotations

import dataclasses
import json
import re
import statistics
import sys
from pathlib import Path

import torch

from sphax_torch import _build, bench, configs, problems
from sphax_torch.neighbors import window as win
from sphax_torch.physics import pm
from sphax_torch.physics import window_kernels as wk

BASES = ("sphax_solve_h_density", "sphax_forces", "sphax_forces_grav",
         "sphax_solve_h_density_2d", "sphax_forces_2d")


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


def _cases(dev):
    """name -> a function that launches one kernel on fixed inputs."""
    a_args = ("pos_s", "mass_s", "h0_s")
    c_args = ("pos_s", "vel_s", "mass_s", "h_s", "rho_s", "P_s", "cs_s",
              "om_s", "bf_s")
    hp = dataclasses.replace(configs.TURB, newton_iters=1, fast_math=True,
                             h_predict=True)
    cold = dataclasses.replace(configs.TURB, newton_iters=1)
    st, dom, spec = bench.setup(100, hp, dev, h_margin=1.05,
                                cutoff_scale=1.05, ghost_safety=1.4,
                                fast_sub=3, rgroups=2)
    wd = win.build(st.pos, dom, spec)
    f = sorted_fields(st, wd)
    cfg_g = dataclasses.replace(configs.TURB, newton_iters=2, gravity=True,
                                grav_solver="p3m", grav_mesh=128)
    st_g, dom_g, spec_g = bench.setup(100, cfg_g, dev, vel_scale=0.0,
                                      h_margin=1.3, cutoff_scale=1.25,
                                      fast_sub=3, rgroups=2)
    wd_g = win.build(st_g.pos, dom_g, spec_g)
    fg = sorted_fields(st_g, wd_g)
    grav = (pm.rs_traced(cfg_g, dom_g, torch.float32, cutoff=spec_g.cutoff),
            cfg_g.grav_eps)

    kh = problems.kh(n=1024, device=dev)
    wd2 = win.build(kh.state.pos, kh.domain, kh.wspec)
    f2 = sorted_fields(kh.state, wd2)

    def a(fields, w, s, cfg):
        return lambda: wk.solve_h_density(w, s, *(fields[k] for k in a_args),
                                          cfg, vel_s=fields["vel_s"])

    def c(fields, w, s, cfg, gr=None):
        return lambda: wk.forces(w, s, *(fields[k] for k in c_args), cfg,
                                 grav=gr)

    return {"A h_predict": a(f, wd, spec, hp), "A cold": a(f, wd, spec, cold),
            "C fast_math": c(f, wd, spec, hp),
            "C grav": c(fg, wd_g, spec_g, cfg_g, grav),
            "C exact": c(fg, wd_g, spec_g, cfg_g),
            "A2 cold": a(f2, wd2, kh.wspec, kh.cfg),
            "C2 exact": c(f2, wd2, kh.wspec, kh.cfg)}


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
    print(json.dumps({
        "card": bench.card(), "rounds": rounds,
        "registers_differ": moved,
        "median_ms": {tag: {k: statistics.median(v) for k, v in t.items()}
                      for tag, t in times.items()},
        "ms": times}))


if __name__ == "__main__":
    main()
