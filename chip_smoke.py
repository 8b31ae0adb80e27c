"""Smoke run of the PyTorch/CUDA port on one card: builds the CUDA kernels
from ``sphax_torch/csrc``, holds each against its plain torch version, and
drives the port's paths at N = 1e6: the bench configuration, the driven CLI
configuration, the same with P3M self-gravity, and an open box with direct
gravity.

    python3 chip_smoke.py

Phases, in order; any failed check raises and exits non-zero:
  1. device    a CUDA card is required; TF32 off; the card's name and
               power limit
  2. build     nvcc builds the kernels; build seconds and registers
  3. kernel A  CUDA vs plain on the same inputs (n_side=48, production
               window knobs, is_real rows), cold Newton and h_predict
               modes, fp32 (rtol 3e-5, atol 3e-5 max) and fp64 (1e-10)
  4. kernel C  the same, then fp32 fast_math against the exact plain
               version at 2e-3
  5. derived   update_derived through the kernels vs through the plain
               versions, on the card (n_side=48, fp32, 3e-5)
  6. main path the bench configuration at N = 1e6: plan, cold derived
               pass, warm-up run and 3 timed runs of 16 steps; bench.py's
               checks; one launch of each kernel per step
  7. driven    the CLI ``turb`` configuration (newton_iters=2, OU driving
               with noise from a seeded generator) at N = 1e6, 4 steps
  8. times     each kernel and its plain version at the N = 1e6 shapes,
               timed with CUDA events
  9. kernel C  gravity mode (fused P3M short range, split scalars from
     + grav    pm.rs_traced at grav_mesh=128) vs plain, n_side=48,
               fp32 (3e-5) and fp64 (1e-10)
 10. kernel G  CUDA vs plain at N = 5000 and N = 64^3, fp32 (1e-4) and
               fp64 (1e-10)
 11. P3M path  the driven configuration with gravity=1 grav_solver=p3m
               grav_mesh=128 at N = 1e6, 4 steps: kernel C in its gravity
               mode every step, and the momentum of one derived pass
 12. direct    the turbulence lattice in an open box with direct gravity at
     path      N = 1e6, one update_derived: kernel G once; its output pulls
               toward the centre and matches the plain sum on sampled rows
 13. times     kernel C with and without gravity at the path-11 shapes,
               kernel G at N = 1e6 and, with its plain version, at 64^3,
               and pm.mesh_accel at N = 1e6, M = 128
Each path runs with every launch count set to 0 just before it, and its
counts are read just after. The line before the last holds the kernels'
record; the last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import sys
import time

import torch


def log(*a):
    print(*a, flush=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; none is visible")

    from sphax_torch import _build, bench, configs, make_state
    from sphax_torch.core.state import box
    from sphax_torch.ics import turbulence
    from sphax_torch.neighbors import window as win
    from sphax_torch.physics import direct_gravity as dg
    from sphax_torch.physics import driving, pm, wengine
    from sphax_torch.physics import window_kernels as wk

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = bench.card()
    name = torch.cuda.get_device_name(0)
    log(f"[1 device] {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.device_count()} card(s)")

    # ---- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    _build.load()
    log(f"[2 build] {time.perf_counter() - t0:.1f} s to build and load "
        f"{_build.library_path().name} "
        f"(nvcc {_build.BUILD_INFO['seconds']} s)")
    for line in _build.BUILD_INFO["ptxas"].splitlines():
        if "registers" in line or "Compiling entry" in line:
            log("   ", line.strip())

    knobs = dict(cutoff_scale=1.05, ghost_safety=1.4, fast_sub=3, rgroups=2)
    TOL = {torch.float32: 3e-5, torch.float64: 1e-10}

    def compare(got, want, real, tol, what):
        """Assert |got - want| <= tol |want| + tol max|want| on ``real``
        rows; return the largest absolute error."""
        got, want = got[real].double(), want[real].double()
        assert bool(torch.isfinite(got).all()), f"{what}: non-finite"
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        bad = (got - want).abs() > tol * want.abs() + tol * scale
        assert not bool(bad.any()), (
            f"{what}: {int(bad.sum())} rows outside rtol=atol/max={tol}; "
            f"max abs err {err:.3g} (scale {scale:.3g})")
        errs[what] = err / scale
        return err

    errs = {}

    def worst(prefix):
        return max(v for k, v in errs.items() if k.startswith(prefix))

    def sorted_inputs(n_side, dtype, seed=1):
        """Sorted kernel inputs at the main path's geometry (owner-consistent
        on ghost rows): positions of the turbulence ICs, a seeded 0.4 N(0,1)
        velocity, and plausible seeded per-particle fields for kernel C."""
        cfg = dataclasses.replace(configs.TURB, newton_iters=1)
        ic = turbulence.build(n_side=n_side)
        st = make_state(*(torch.as_tensor(ic[k], dtype=dtype, device=dev)
                          for k in ("pos", "vel", "mass", "u", "h")))
        g = torch.Generator(device=dev).manual_seed(seed)

        def rnd(lo, hi, shape=(st.n,)):
            return lo + (hi - lo) * torch.rand(shape, generator=g,
                                               dtype=dtype, device=dev)
        vel = 0.4 * torch.randn(st.vel.shape, generator=g, dtype=dtype,
                                device=dev)
        dom = box(torch.zeros(3, dtype=dtype, device=dev),
                  torch.ones(3, dtype=dtype, device=dev))
        spec = win.plan_measured(st.pos, dom,
                                 h_max=float(st.h.max()) * 1.05, dim=3,
                                 **knobs)
        wd = win.build(st.pos, dom, spec)
        rho = rnd(0.8, 1.2)
        cols = {"vel_s": (vel, 0.0), "mass_s": (st.mass, 0.0),
                "h0_s": (st.h, 1.0), "h_s": (st.h * rnd(0.95, 1.05), 1.0),
                "rho_s": (rho, 1.0), "P_s": (rho * rnd(0.9, 1.1), 1.0),
                "cs_s": (rnd(0.8, 1.2), 1.0), "om_s": (rnd(0.9, 1.1), 1.0),
                "bf_s": (rnd(0.0, 1.0), 0.0)}
        f = {k: win.gather_sorted(v, wd, fill) for k, (v, fill)
             in cols.items()}
        f["pos_s"] = wd.pos_s
        return cfg, spec, wd, f

    A_MODES = {
        "cold": dataclasses.replace(configs.TURB, newton_iters=1),
        "h_predict": dataclasses.replace(configs.TURB, newton_iters=1,
                                         h_predict=True),
    }
    A_ARGS = ("pos_s", "mass_s", "h0_s")
    C_ARGS = ("pos_s", "vel_s", "mass_s", "h_s", "rho_s", "P_s", "cs_s",
              "om_s", "bf_s")

    # ---- 3. kernel A parity ---------------------------------------------
    for dtype in (torch.float32, torch.float64):
        _, spec, wd, f = sorted_inputs(48, dtype)
        for mode, cfg in A_MODES.items():
            args = [f[k] for k in A_ARGS]
            got = wk.solve_h_density(wd, spec, *args, cfg, vel_s=f["vel_s"])
            want = wk.solve_h_density_plain(wd, spec, *args, cfg,
                                             vel_s=f["vel_s"])
            torch.cuda.synchronize()
            e = max(compare(a, b, wd.is_real, TOL[dtype],
                            f"A {mode} {dtype} out{k}")
                    for k, (a, b) in enumerate(zip(got, want)))
            log(f"[3 kernel A] {mode:9s} {str(dtype):13s} n={spec.n_sorted} "
                f"wseg={spec.wseg}: max abs err {e:.3g}, max err/scale "
                f"{worst(f'A {mode} {dtype}'):.3g} (tol {TOL[dtype]})")

    # ---- 4. kernel C parity ---------------------------------------------
    for dtype in (torch.float32, torch.float64):
        cfg, spec, wd, f = sorted_inputs(48, dtype)
        args = [f[k] for k in C_ARGS]
        got = wk.forces(wd, spec, *args, cfg)
        want = wk.forces_plain(wd, spec, *args, cfg)
        torch.cuda.synchronize()
        e = max(compare(got[0], want[0], wd.is_real, TOL[dtype],
                        f"C {dtype} acc"),
                compare(got[1], want[1], wd.is_real, TOL[dtype],
                        f"C {dtype} du"))
        log(f"[4 kernel C] exact     {str(dtype):13s}: max abs err {e:.3g}, "
            f"max err/scale {worst(f'C {dtype}'):.3g} (tol {TOL[dtype]})")
        if dtype == torch.float32:
            fast = dataclasses.replace(cfg, fast_math=True)
            got = wk.forces(wd, spec, *args, fast)
            torch.cuda.synchronize()
            e = max(compare(got[0], want[0], wd.is_real, 2e-3,
                            "C fast_math acc"),
                    compare(got[1], want[1], wd.is_real, 2e-3,
                            "C fast_math du"))
            log(f"[4 kernel C] fast_math float32 vs exact plain: max abs "
                f"err {e:.3g}, max err/scale {worst('C fast_math'):.3g} "
                f"(tol 2e-3)")

    # ---- 5. derived pass: kernels vs plain versions, on the card ---------
    @contextlib.contextmanager
    def plain_kernels():
        saved = wk.solve_h_density, wk.forces
        wk.solve_h_density, wk.forces = wk.solve_h_density_plain, \
            wk.forces_plain
        try:
            yield
        finally:
            wk.solve_h_density, wk.forces = saved

    cfg = dataclasses.replace(configs.TURB, newton_iters=1)
    st, dom, spec = bench.setup(48, cfg, dev, vel_scale=0.4, **knobs)
    got = wengine.update_derived(st, cfg, dom, spec)
    with plain_kernels():
        want = wengine.update_derived(st, cfg, dom, spec)
    torch.cuda.synchronize()
    every = torch.ones(st.n, dtype=torch.bool, device=dev)
    e = max(compare(getattr(got, k), getattr(want, k), every, 3e-5,
                    f"derived {k}")
            for k in ("h", "rho", "P", "omega", "divv", "acc", "du_dt"))
    log(f"[5 derived] update_derived kernels vs plain, n={st.n}: max abs "
        f"err {e:.3g}, max err/scale {worst('derived'):.3g} (tol 3e-5)")

    paths = {}

    def drive(name, run, want):
        """Run one path with every launch count set to 0 just before it;
        read the counts just after and hold them to ``want`` (kernels
        absent from it must not launch)."""
        for k in wk.LAUNCHES:
            wk.LAUNCHES[k] = 0
        out = run()
        torch.cuda.synchronize()
        paths[name] = dict(wk.LAUNCHES)
        assert paths[name] == {k: want.get(k, 0) for k in wk.LAUNCHES}, (
            name, paths[name])
        return out

    # ---- 6. main path ----------------------------------------------------
    t0 = time.perf_counter()
    per = 1 + 4 * 16      # cold derived pass + warm-up and 3 timed runs
    res, st_main, dom_main, spec_main = drive(
        "bench", lambda: bench.run(n_side=100, steps=16, reps=3, device=dev),
        {"solve_h_density": per, "forces": per})
    res.update(particle_steps_per_s=res["value"], launches=paths["bench"],
               card=card, setup_and_runs_s=time.perf_counter() - t0)
    log("[6 main path]", json.dumps(res))

    # ---- 7. driven phase (CLI turb configuration) ------------------------
    cfg_d = dataclasses.replace(configs.TURB, newton_iters=2)
    st, dom, spec = bench.setup(100, cfg_d, dev, vel_scale=0.0,
                                h_margin=1.3, cutoff_scale=1.25, fast_sub=3,
                                rgroups=2)
    modes = tuple(map(tuple, driving.make_modes(1, 2).astype(int)))
    dspec = driving.DriveSpec(modes=modes, tau=0.5, accel_rms=3.0)
    gen = torch.Generator(device=dev).manual_seed(1)
    t0 = time.perf_counter()
    st, dr, dts, ovf = drive("driven", lambda: wengine.simulate(
        st, cfg_d, dom, spec, 4, rebuild_every=2,
        drive=driving.init(len(modes), dtype=torch.float32, device=dev),
        drive_spec=dspec, noise=driving.gaussian_noise(gen)),
        {"solve_h_density": 4, "forces": 4})
    wall = time.perf_counter() - t0
    assert int(ovf) == 0, f"overflow {int(ovf)} in the driven phase"
    for f_ in ("pos", "vel", "h", "rho", "acc", "du_dt"):
        assert bool(torch.isfinite(getattr(st, f_)).all()), f_
    assert bool((dts > 0).all()) and bool(torch.isfinite(dr.amp_re).all())
    vrms = float(st.vel.pow(2).sum(-1).mean().sqrt())
    log(f"[7 driven] N={st.n} wseg={spec.wseg} 4 steps in {wall:.3f} s, "
        f"overflow 0, v_rms {vrms:.4g}, h_residual "
        f"{bench.h_residual(st, cfg_d):.3g}")

    # ---- 8. kernel times at the N = 1e6 shapes ---------------------------
    cfg = dataclasses.replace(configs.TURB, newton_iters=1, fast_math=True,
                              h_predict=True)
    wd = win.build(st_main.pos, dom_main, spec_main)
    c = torch.cat([st_main.pos, st_main.vel, st_main.mass[:, None],
                   st_main.h[:, None], st_main.rho[:, None],
                   st_main.P[:, None], st_main.cs[:, None],
                   st_main.omega[:, None]], dim=-1)
    g = win.gather_sorted_cols(c, wd, [0.0] * 6 + [0.0] + [1.0] * 5)
    f = dict(pos_s=wd.pos_s, vel_s=g[:, 3:6], mass_s=g[:, 6], h0_s=g[:, 7],
             h_s=g[:, 7], rho_s=g[:, 8], P_s=g[:, 9], cs_s=g[:, 10],
             om_s=g[:, 11], bf_s=torch.ones_like(g[:, 11]))
    f = {k: v.contiguous() for k, v in f.items()}
    real = wd.is_real

    def cuda_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(reps):
            out = fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps, out

    times = {}
    for label, kcfg in (("A cold", A_MODES["cold"]),
                        ("A h_predict", cfg)):
        args = [f[k] for k in A_ARGS]
        ms, got = cuda_ms(lambda: wk.solve_h_density(
            wd, spec_main, *args, kcfg, vel_s=f["vel_s"]), 10)
        pms, want = cuda_ms(lambda: wk.solve_h_density_plain(
            wd, spec_main, *args, kcfg, vel_s=f["vel_s"]), 2)
        e = max(compare(a, b, real, 3e-5, f"{label} at N=1e6")
                for a, b in zip(got, want))
        times[label] = (ms, pms, e)
        log(f"[8 times] {label:12s} kernel {ms:.3f} ms  plain {pms:.1f} ms "
            f" max abs err {e:.3g}")
    args = [f[k] for k in C_ARGS]
    ms, got = cuda_ms(lambda: wk.forces(wd, spec_main, *args, cfg), 10)
    pms, want = cuda_ms(lambda: wk.forces_plain(wd, spec_main, *args, cfg), 2)
    e = max(compare(got[0], want[0], real, 2e-3, "C fast_math at N=1e6"),
            compare(got[1], want[1], real, 2e-3, "C fast_math du at N=1e6"))
    times["C"] = (ms, pms, e)
    log(f"[8 times] {'C fast_math':12s} kernel {ms:.3f} ms  plain {pms:.1f} "
        f"ms  max abs err {e:.3g}")
    walked, computed = candidate_rows(wd, spec_main)
    log(f"[8 times] candidate rows per real row at N=1e6: walked {walked:.1f}"
        f", computed {computed:.1f}")

    # ---- 9. kernel C gravity mode parity --------------------------------
    def p3m_cfg(cfg):
        return dataclasses.replace(cfg, gravity=True, grav_solver="p3m",
                                   grav_mesh=128)

    for dtype in (torch.float32, torch.float64):
        cfg, spec, wd, f = sorted_inputs(48, dtype)
        cfg = p3m_cfg(cfg)
        dom = box(torch.zeros(3, dtype=dtype, device=dev),
                  torch.ones(3, dtype=dtype, device=dev))
        grav = (pm.rs_traced(cfg, dom, dtype, cutoff=spec.cutoff),
                cfg.grav_eps)
        args = [f[k] for k in C_ARGS]
        got = wk.forces(wd, spec, *args, cfg, grav=grav)
        want = wk.forces_plain(wd, spec, *args, cfg, grav=grav)
        torch.cuda.synchronize()
        e = max(compare(got[0], want[0], wd.is_real, TOL[dtype],
                        f"Cg {dtype} acc"),
                compare(got[1], want[1], wd.is_real, TOL[dtype],
                        f"Cg {dtype} du"))
        log(f"[9 kernel C+grav] {str(dtype):13s} rs {float(grav[0]):.4g} "
            f"cutoff {spec.cutoff:.4g}: max abs err {e:.3g}, max err/scale "
            f"{worst(f'Cg {dtype}'):.3g} (tol {TOL[dtype]})")

    # ---- 10. kernel G parity ---------------------------------------------
    G_TOL = {torch.float32: 1e-4, torch.float64: 1e-10}
    cfg_gt = configs.SPHConfig(gravity=True, G=1.4, grav_eps=0.03)

    def cloud(n, dtype, seed=3):
        g = torch.Generator(device=dev).manual_seed(seed)
        pos = torch.rand((n, 3), generator=g, dtype=dtype, device=dev)
        return pos, (torch.rand(n, generator=g, dtype=dtype,
                                device=dev) + 0.5) / n

    for n in (5000, 64 ** 3):
        for dtype in (torch.float32, torch.float64):
            pos, mass = cloud(n, dtype)
            got = dg.gravity(pos, mass, cfg_gt)
            want = dg.gravity_plain(pos, mass, cfg_gt)
            torch.cuda.synchronize()
            every = torch.ones(n, dtype=torch.bool, device=dev)
            e = compare(got, want, every, G_TOL[dtype], f"G {n} {dtype}")
            log(f"[10 kernel G] N={n:7d} {str(dtype):13s}: max abs err "
                f"{e:.3g}, max err/scale {worst(f'G {n} {dtype}'):.3g} "
                f"(tol {G_TOL[dtype]})")
    del pos, mass, got, want

    # ---- 11. P3M path: the driven configuration with self-gravity --------
    cfg_g = p3m_cfg(cfg_d)
    st, dom, spec = bench.setup(100, cfg_g, dev, vel_scale=0.0,
                                h_margin=1.3, cutoff_scale=1.25, fast_sub=3,
                                rgroups=2)
    rs_g = pm.rs_traced(cfg_g, dom, torch.float32, cutoff=spec.cutoff)
    rs_cells = float(rs_g) * cfg_g.grav_mesh / float(dom.extent.min())

    def p3m_run(st, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return wengine.simulate(
            st, cfg_g, dom, spec, 4, rebuild_every=2,
            drive=driving.init(len(modes), dtype=torch.float32, device=dev),
            drive_spec=dspec, noise=driving.gaussian_noise(gen))

    t0 = time.perf_counter()
    st_g, dr, dts, ovf = drive("p3m", lambda: p3m_run(st, 1),
                               {"solve_h_density": 4, "forces_grav": 4})
    wall_g = time.perf_counter() - t0
    assert int(ovf) == 0, f"overflow {int(ovf)} in the P3M path"
    for f_ in ("pos", "vel", "h", "rho", "acc", "du_dt"):
        assert bool(torch.isfinite(getattr(st_g, f_)).all()), f_
    assert bool((dts > 0).all()) and bool(torch.isfinite(dr.amp_re).all())
    t0 = time.perf_counter()
    p3m_run(st_g, 2)                      # warm: the step time
    torch.cuda.synchronize()
    step_g = (time.perf_counter() - t0) / 4
    # total momentum of one derived pass, before the driving term: the
    # symmetrized SPH pairs cancel to roundoff, so this holds the mesh and
    # the fused short range to test_pm.py's gate
    wd_g = win.build(st_g.pos, dom, spec)
    out = wengine.derived_with(st_g, wd_g, cfg_g, dom, spec)
    ma = (st_g.mass[:, None] * out.acc).double()
    mom = (ma.sum(0).abs() / ma.abs().sum(0)).max().item()
    assert mom < 2e-3, f"momentum {mom} in the P3M derived pass"
    log(f"[11 P3M path] N={st_g.n} wseg={spec.wseg} rs={float(rs_g):.5g} = "
        f"{rs_cells:.3f} mesh cells (cutoff {spec.cutoff:.5g}); 4 steps in "
        f"{wall_g:.3f} s cold, {step_g * 1e3:.1f} ms/step warm; overflow 0,"
        f" h_residual {bench.h_residual(st_g, cfg_g):.3g}, |sum m a| / "
        f"sum |m a| = {mom:.3g} (< 2e-3)")

    # ---- 12. direct path: open box, kernel G -----------------------------
    cfg_dir = dataclasses.replace(configs.TURB, gravity=True,
                                  grav_solver="direct", grav_eps=0.01)
    ic = turbulence.build(n_side=100)
    st_o = make_state(*(torch.as_tensor(ic[k], dtype=torch.float32,
                                        device=dev)
                        for k in ("pos", "vel", "mass", "u", "h")))
    dom_o = box(torch.zeros(3, device=dev), torch.ones(3, device=dev),
                periodic=False)
    spec_o = win.plan_measured(st_o.pos, dom_o,
                               h_max=float(st_o.h.max()) * 1.05, dim=3,
                               **knobs)
    t0 = time.perf_counter()
    out = drive("direct", lambda: wengine.update_derived(
        st_o, cfg_dir, dom_o, spec_o),
        {"solve_h_density": 1, "forces": 1, "gravity": 1})
    wall_o = time.perf_counter() - t0
    for f_ in ("h", "rho", "acc", "du_dt"):
        assert bool(torch.isfinite(getattr(out, f_)).all()), f_
    a_g = dg.gravity(st_o.pos, st_o.mass, cfg_dir)
    d = st_o.pos - 0.5
    radial = float(((d * a_g).sum(-1) / d.norm(dim=-1).clamp_min(1e-12))
                   .mean())
    assert radial < 0.0, f"kernel G's mean radial acceleration {radial}"
    rows = torch.randperm(st_o.n, device=dev,
                          generator=torch.Generator(device=dev)
                          .manual_seed(4))[:8192]
    want = dg.gravity_plain(st_o.pos, st_o.mass, cfg_dir, rows=rows)
    g_e = compare(a_g[rows], want, torch.ones_like(rows, dtype=torch.bool),
                  1e-4, "G at N=1e6")
    log(f"[12 direct path] N={st_o.n} open box, one update_derived in "
        f"{wall_o:.3f} s; kernel G's mean radial acceleration {radial:.4g} "
        f"(< 0); vs plain on 8192 sampled rows: max abs err {g_e:.3g}, max "
        f"err/scale {errs['G at N=1e6']:.3g} (tol 1e-4)")

    # ---- 13. gravity times -----------------------------------------------
    c = torch.cat([st_g.pos, st_g.vel, st_g.mass[:, None], st_g.h[:, None],
                   st_g.rho[:, None], st_g.P[:, None], st_g.cs[:, None],
                   st_g.omega[:, None]], dim=-1)
    g = win.gather_sorted_cols(c, wd_g, [0.0] * 6 + [0.0] + [1.0] * 5)
    fg = dict(pos_s=wd_g.pos_s, vel_s=g[:, 3:6], mass_s=g[:, 6],
              h_s=g[:, 7], rho_s=g[:, 8], P_s=g[:, 9], cs_s=g[:, 10],
              om_s=g[:, 11], bf_s=torch.ones_like(g[:, 11]))
    args = [fg[k].contiguous() for k in C_ARGS]
    grav = (rs_g, cfg_g.grav_eps)
    cg = {}
    for label, gr in (("with", grav), ("without", None)):
        ms, got = cuda_ms(lambda: wk.forces(wd_g, spec, *args, cfg_g,
                                            grav=gr), 10)
        pms, want = cuda_ms(lambda: wk.forces_plain(wd_g, spec, *args,
                                                    cfg_g, grav=gr), 1)
        e = max(compare(a, b, wd_g.is_real, 3e-5, f"C {label} grav at N=1e6")
                for a, b in zip(got, want))
        cg[label] = (ms, pms, e)
        log(f"[13 times] C {label:7s} gravity, P3M path shapes: kernel "
            f"{ms:.3f} ms  plain {pms:.1f} ms  max abs err {e:.3g}")
    del got, want
    walked_g, _ = candidate_rows(wd_g, spec)
    log(f"[13 times] candidate rows per real row, P3M path: walked "
        f"{walked_g:.1f}")
    g_ms_1e6, _ = cuda_ms(lambda: dg.gravity(st_o.pos, st_o.mass, cfg_dir), 2)
    pos, mass = cloud(64 ** 3, torch.float32)
    g_ms, got = cuda_ms(lambda: dg.gravity(pos, mass, cfg_gt), 5)
    g_pms, want = cuda_ms(lambda: dg.gravity_plain(pos, mass, cfg_gt), 1)
    compare(got, want, torch.ones(pos.shape[0], dtype=torch.bool,
                                  device=dev), 1e-4, "G timed 64^3")
    log(f"[13 times] G fp32: N=1e6 kernel {g_ms_1e6:.2f} ms; N=64^3 kernel "
        f"{g_ms:.3f} ms  plain {g_pms:.1f} ms")
    mesh_ms, _ = cuda_ms(lambda: pm.mesh_accel(st_g.pos, st_g.mass, cfg_g,
                                               dom, rs=rs_g), 10)
    # back-to-back calls time the host's launches of ~100 small torch
    # kernels; the profiler gives the device time those kernels take
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        pm.mesh_accel(st_g.pos, st_g.mass, cfg_g, dom, rs=rs_g)
        torch.cuda.synchronize()
    mesh_dev_ms = sum(e.time_range.elapsed_us() for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    log(f"[13 times] pm.mesh_accel N=1e6 M=128: {mesh_ms:.3f} ms a call "
        f"back to back ({100 * mesh_ms / (step_g * 1e3):.1f} % of a warm "
        f"P3M step), device time {mesh_dev_ms:.3f} ms (profiler)")

    def total(kernel):
        return sum(p_[kernel] for p_ in paths.values())

    src = "sphax_torch/csrc/window_kernels.cu"
    a_ms, a_pms, a_e = times["A h_predict"]
    c_ms, c_pms, c_e = times["C"]
    kernels = {"kernels": [
        {"name": "solve_h_density", "route": "cuda", "source": src,
         "replaces": "sphax/physics/pallas_kernels.py:315",
         "launches": total("solve_h_density"), "max_abs_err": a_e,
         "ms": a_ms, "plain_ms": a_pms,
         "ms_cold": times["A cold"][0], "plain_ms_cold": times["A cold"][1]},
        {"name": "forces", "route": "cuda", "source": src,
         "replaces": "sphax/physics/pallas_kernels.py:563",
         "launches": total("forces") + total("forces_grav"),
         "launches_grav": total("forces_grav"), "max_abs_err": c_e,
         "ms": c_ms, "plain_ms": c_pms,
         "grav": {"replaces": "sphax/physics/pallas_kernels.py:747",
                  "ms": cg["with"][0], "plain_ms": cg["with"][1],
                  "max_abs_err": cg["with"][2],
                  "ms_without_grav": cg["without"][0],
                  "plain_ms_without_grav": cg["without"][1]}},
        {"name": "gravity", "route": "cuda",
         "source": "sphax_torch/csrc/gravity_kernel.cu",
         "replaces": "sphax/physics/pallas_kernels.py:808",
         "launches": total("gravity"), "max_abs_err": g_e,
         "ms": g_ms, "plain_ms": g_pms, "n": 64 ** 3,
         "ms_n1e6": g_ms_1e6},
    ], "launches_by_path": paths, "mesh_accel_ms": mesh_ms,
        "mesh_accel_device_ms": mesh_dev_ms,
        "p3m_step_ms": step_g * 1e3, "rs_mesh_cells": rs_cells,
        "candidate_rows_walked_p3m": walked_g,
        "candidate_rows_walked": walked,
        "candidate_rows_computed": computed, "card": card}
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


def candidate_rows(wd, spec):
    """Mean candidate rows per real sorted row that the kernels walk (the
    segment ranges [w_lo, w_lo + 128 w_nact), duplicates included) and that
    they compute pair math for (each row of the ranges' union once)."""
    lo = wd.w_lo.long()
    hi = lo + 128 * wd.w_nact.long()
    walked = (hi - lo).sum(1)
    # a range overlaps the earlier ranges' union only below their running
    # maximum end (the ranges rise with the segment offset)
    prev_hi = torch.cummax(hi, 1).values[:, :-1]
    overlap = (torch.minimum(prev_hi, hi[:, 1:]) - lo[:, 1:]).clamp_min(0)
    computed = walked - overlap.sum(1)
    real = wd.is_real
    return tuple(float(x.repeat_interleave(spec.group)[real].double().mean())
                 for x in (walked, computed))


if __name__ == "__main__":
    main()
    sys.exit(0)
