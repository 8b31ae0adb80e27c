"""Kernels A and C built from two source trees, timed in one process on one
card.

    python -m sphax_torch.ab_kernels OTHER_CSRC [ROUNDS]

OTHER_CSRC is another version's ``sphax_torch/csrc`` (for example a parent
commit unpacked with ``git archive`` into a directory that ``.gitignore``
lists). Both trees are built. The 3D kernels then run on the same sorted
inputs at N = 1e6: A (h_predict and cold) and C (fast_math) at the bench
configuration's shapes, and C exact with and without the P3M gravity mode at
the P3M path's shapes (``chip_smoke.py`` phases 8 and 13). The versions take
turns in the order this, other, other, this, for ROUNDS rounds (default 3);
each time is CUDA events over 10 launches. Prints what ptxas reports for
both builds and one JSON line with each version's median ms per case.
"""
from __future__ import annotations

import dataclasses
import json
import re
import statistics
import sys
from pathlib import Path

import torch

from sphax_torch import _build, bench, configs
from sphax_torch.neighbors import window as win
from sphax_torch.physics import pm
from sphax_torch.physics import window_kernels as wk

BASES = ("sphax_solve_h_density", "sphax_forces", "sphax_forces_grav")


def registers(ptxas: str) -> dict:
    """Kernel name -> registers per thread, from ptxas's -v output."""
    out, name = {}, None
    for line in ptxas.splitlines():
        m = re.search(r"entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = int(m.group(1))
            name = None
    return out


def _sorted_fields(st, wd):
    """The kernels' sorted inputs for the state ``st`` (3D)."""
    c = torch.cat([st.pos, st.vel, st.mass[:, None], st.h[:, None],
                   st.rho[:, None], st.P[:, None], st.cs[:, None],
                   st.omega[:, None]], dim=-1)
    g = win.gather_sorted_cols(c, wd, [0.0] * 6 + [0.0] + [1.0] * 5)
    f = dict(pos_s=wd.pos_s, vel_s=g[:, 3:6], mass_s=g[:, 6], h0_s=g[:, 7],
             h_s=g[:, 7], rho_s=g[:, 8], P_s=g[:, 9], cs_s=g[:, 10],
             om_s=g[:, 11], bf_s=torch.ones_like(g[:, 11]))
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
    f = _sorted_fields(st, wd)
    cfg_g = dataclasses.replace(configs.TURB, newton_iters=2, gravity=True,
                                grav_solver="p3m", grav_mesh=128)
    st_g, dom_g, spec_g = bench.setup(100, cfg_g, dev, vel_scale=0.0,
                                      h_margin=1.3, cutoff_scale=1.25,
                                      fast_sub=3, rgroups=2)
    wd_g = win.build(st_g.pos, dom_g, spec_g)
    fg = _sorted_fields(st_g, wd_g)
    grav = (pm.rs_traced(cfg_g, dom_g, torch.float32, cutoff=spec_g.cutoff),
            cfg_g.grav_eps)

    def a(cfg):
        return lambda: wk.solve_h_density(wd, spec, *(f[k] for k in a_args),
                                          cfg, vel_s=f["vel_s"])

    def c(fields, w, s, cfg, gr=None):
        return lambda: wk.forces(w, s, *(fields[k] for k in c_args), cfg,
                                 grav=gr)

    return {"A h_predict": a(hp), "A cold": a(cold),
            "C fast_math": c(f, wd, spec, hp),
            "C grav": c(fg, wd_g, spec_g, cfg_g, grav),
            "C exact": c(fg, wd_g, spec_g, cfg_g)}


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
        _build.BUILD_INFO.update(ptxas="")
        libs[tag] = _build.open_library(_build.build(sources), BASES)
        regs[tag] = registers(_build.BUILD_INFO["ptxas"])
    for tag in regs:
        for name, n in sorted(regs[tag].items()):
            print(f"{tag:5s} {n:4d} registers  {name}")
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
        "median_ms": {tag: {k: statistics.median(v) for k, v in t.items()}
                      for tag, t in times.items()},
        "ms": times}))


if __name__ == "__main__":
    main()
