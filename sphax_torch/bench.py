"""Headline benchmark of the port: particle-steps/s on one CUDA card.

    python -m sphax_torch.bench

The twin of the repository's ``bench.py`` (same configuration, same checks,
same JSON keys), driving ``sphax_torch`` through the CUDA window kernels:
the driven isothermal turbulence box (``configs.TURB`` with one Newton
iteration, ``fast_math`` and the h predictor) at N = 100^3, the sorted
pencil-window engine with a rebuild every 2 steps, 16 steps a run, the
median of 3 timed runs after one warm-up run. Prints ONE JSON line.

The same environment knobs as ``bench.py`` select variants (BENCH_NSIDE,
BENCH_STEPS, BENCH_REBUILD, BENCH_CUTOFF_SCALE, BENCH_HMARGIN,
BENCH_FAST_SUB, BENCH_RGROUPS, BENCH_HPRED); candidate compaction and
drift-gated rebuilds are not ported yet. ``vs_baseline`` is null: the port
has no baseline of its own yet.
"""
from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import time

import torch

from sphax_torch import configs, make_state
from sphax_torch.core.state import box
from sphax_torch.ics import turbulence
from sphax_torch.neighbors import window as win
from sphax_torch.physics import wengine
from sphax_torch.physics import window_kernels as wk


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def setup(n_side, cfg, device, dtype=torch.float32, vel_scale=0.3, seed=0,
          h_margin=1.05, **knobs):
    """Turbulence ICs on ``device`` with a seeded normal velocity field, the
    measured window plan and the cold derived pass. Returns (state, domain,
    spec)."""
    ic = turbulence.build(n_side=n_side)
    st = make_state(*(torch.as_tensor(ic[k], dtype=dtype, device=device)
                      for k in ("pos", "vel", "mass", "u", "h")))
    gen = torch.Generator(device=device).manual_seed(seed)
    st = st._replace(vel=vel_scale * torch.randn(
        st.vel.shape, generator=gen, dtype=dtype, device=device))
    dom = box(torch.zeros(3, dtype=dtype, device=device),
              torch.as_tensor(ic["box"], dtype=dtype, device=device))
    spec = win.plan_measured(st.pos, dom, h_max=float(st.h.max()) * h_margin,
                             dim=3, **knobs)
    return wengine.update_derived(st, cfg, dom, spec), dom, spec


def h_residual(st, cfg) -> float:
    """Largest relative miss of rho = m (eta / h)^3."""
    return float(torch.max(torch.abs(st.rho - st.mass * (cfg.eta / st.h) ** 3)
                           / st.rho))


def run(n_side=100, steps=16, rebuild_every=2, cutoff_scale=1.05,
        h_margin=1.05, fast_sub=3, rgroups=2, h_predict=True, reps=3,
        device="cuda"):
    """Set up, warm up, time ``reps`` runs of ``steps`` steps; check the
    result as ``bench.py`` does. Returns (result dict, final state, domain,
    spec)."""
    cfg = dataclasses.replace(configs.TURB, newton_iters=1, fast_math=True,
                              h_predict=h_predict)
    st, dom, spec = setup(n_side, cfg, device, h_margin=h_margin,
                          cutoff_scale=cutoff_scale, ghost_safety=1.4,
                          fast_sub=fast_sub, rgroups=rgroups)

    def one(s):
        before = dict(wk.LAUNCHES)
        out = wengine.simulate(s, cfg, dom, spec, steps,
                               rebuild_every=rebuild_every)
        if s.pos.is_cuda:
            # one launch of each kernel per step, and no plain version
            for k in before:
                assert wk.LAUNCHES[k] - before[k] == steps, (k, wk.LAUNCHES)
        return out

    st2, _, dts, ovf = one(st)              # warm-up
    walls = []
    for _ in range(reps):
        if st2.pos.is_cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        st2, _, dts, ovf = one(st2)
        if st2.pos.is_cuda:
            torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)

    assert bool(torch.isfinite(st2.rho).all()), "non-finite state in bench"
    assert bool((dts > 0).all()), "non-positive dt in bench"
    assert int(ovf) == 0, f"window structure overflow in bench: {int(ovf)}"
    res = h_residual(st2, cfg)
    assert res < 5e-3, f"h not converged: {res}"
    pss = st.n * steps / wall
    out = {
        "metric": "particle_steps_per_sec_per_chip",
        "value": pss,
        "unit": "particle-steps/s/chip",
        "vs_baseline": None,
        "n_particles": st.n,
        "steps": steps,
        "wall_s": wall,
        "engine": "torch-cuda-window",
        "wseg": spec.wseg,
        "h_residual": res,
        "device": (torch.cuda.get_device_name(st2.pos.device)
                   if st2.pos.is_cuda else str(st2.pos.device)),
    }
    return out, st2, dom, spec


def main():
    if not torch.cuda.is_available():
        raise SystemExit("sphax_torch.bench needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    env = os.environ.get
    out, *_ = run(n_side=int(env("BENCH_NSIDE", 100)),
                    steps=int(env("BENCH_STEPS", 16)),
                    rebuild_every=int(env("BENCH_REBUILD", 2)),
                    cutoff_scale=float(env("BENCH_CUTOFF_SCALE", 1.05)),
                    h_margin=float(env("BENCH_HMARGIN", 1.05)),
                    fast_sub=int(env("BENCH_FAST_SUB", 3)),
                    rgroups=int(env("BENCH_RGROUPS", 2)),
                    h_predict=bool(int(env("BENCH_HPRED", 1))))
    out["card"] = card()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
