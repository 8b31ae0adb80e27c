"""Smoke run of the PyTorch/CUDA port on one card: builds the CUDA window
kernels from ``sphax_torch/csrc``, holds each against its plain torch
version, and drives the port's main path (the bench configuration at
N = 1e6, then the driven CLI configuration).

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
The line before the last holds the kernels' record; the last line is
{"ok": true, "device": {...}}.
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
    from sphax_torch.physics import driving, wengine
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

    # ---- 6. main path ----------------------------------------------------
    for k in wk.LAUNCHES:
        wk.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    res, st_main, dom_main, spec_main = bench.run(n_side=100, steps=16,
                                                  reps=3, device=dev)
    torch.cuda.synchronize()
    launches = dict(wk.LAUNCHES)
    per = 1 + 4 * 16      # cold derived pass + warm-up and 3 timed runs
    assert launches == {k: per for k in launches}, launches
    res.update(particle_steps_per_s=res["value"], launches=launches,
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
    before = dict(wk.LAUNCHES)
    t0 = time.perf_counter()
    st, dr, dts, ovf = wengine.simulate(
        st, cfg_d, dom, spec, 4, rebuild_every=2,
        drive=driving.init(len(modes), dtype=torch.float32, device=dev),
        drive_spec=dspec, noise=driving.gaussian_noise(gen))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    assert int(ovf) == 0, f"overflow {int(ovf)} in the driven phase"
    for f_ in ("pos", "vel", "h", "rho", "acc", "du_dt"):
        assert bool(torch.isfinite(getattr(st, f_)).all()), f_
    assert bool((dts > 0).all()) and bool(torch.isfinite(dr.amp_re).all())
    assert all(wk.LAUNCHES[k] - before[k] == 4 for k in before)
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

    src = "sphax_torch/csrc/window_kernels.cu"
    a_ms, a_pms, a_e = times["A h_predict"]
    c_ms, c_pms, c_e = times["C"]
    kernels = {"kernels": [
        {"name": "solve_h_density", "route": "cuda", "source": src,
         "replaces": "sphax/physics/pallas_kernels.py:315",
         "launches": launches["solve_h_density"], "max_abs_err": a_e,
         "ms": a_ms, "plain_ms": a_pms,
         "ms_cold": times["A cold"][0], "plain_ms_cold": times["A cold"][1]},
        {"name": "forces", "route": "cuda", "source": src,
         "replaces": "sphax/physics/pallas_kernels.py:563",
         "launches": launches["forces"], "max_abs_err": c_e,
         "ms": c_ms, "plain_ms": c_pms},
    ], "candidate_rows_walked": walked,
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
