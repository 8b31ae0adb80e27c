"""CLI entry point: ``python -m sphax_torch <problem> [key=value ...]``.

The twin of ``python -m sphax``'s single-device loop: a named problem,
key=value overrides (every SPHConfig field; unknown keys raise), JSONL
metrics, npz snapshots, checkpoint/resume and an optional profiler trace.
Examples:

    python -m sphax_torch kh n=1024 max_steps=16 out=runs/kh
    python -m sphax_torch kh n=1024 smooth=1 out=runs/kh_mcnally
    python -m sphax_torch turb n=100 t_end=1.0 out=runs/turb
    python -m sphax_torch turb resume=runs/turb/checkpoint.npz
    python -m sphax_torch cloud n=256 jeans=222 mesh=384 out=runs/cloud
    python -m sphax_torch sod n=8 device=cpu

``cloud`` is a periodic self-gravitating isothermal cloud (Klessen, Burkert
& Bate 1998) from Gaussian density fluctuations: the box holds ``jeans``
Jeans masses (M / M_J with M_J = rho0 lambda_J^3, lambda_J = (pi c_s^2 /
(G rho0))^(1/2), so G = pi jeans^(2/3) in code units), with P3M gravity on
a ``mesh``^3 FFT mesh and kernel C's gravity mode for the short range.

``kh smooth=1`` sets up McNally, Lyra & Passy 2012's well-posed
Kelvin-Helmholtz test (interfaces smoothed over L = 0.025, vy = 0.01
sin(4 pi x)) in place of the sharp interfaces of ``smooth=0``, the default.

``device=cuda`` (the default) runs on the card and raises where none is
visible; ``device=cpu`` runs on the CPU. Window-engine problems run through
``wengine.simulate`` (a structure overflow aborts the run), the others
through ``run.simulate``. ``adaptive=K`` rebuilds the window structure on
the drift gate, with at most K steps of staleness, instead of every 2
steps; each metrics record then carries ``rebuilds``, the builds of its
chunk. The dense engine ignores it, as the JAX CLI does.

``rungs=B`` (B > 1) integrates with block timesteps on B power-of-two rungs
(``integrate.rungs.simulate_rungs``): a chunk is ceil(chunk / 2^(B-1))
whole spans of 2^(B-1) ticks, a tick counts as a step, ``adaptive=K`` is
passed through, and each record carries ``dt_viol`` and ``active_frac``.
``sedov ... limiter=A`` (A a power of two, e.g. ``sedov n=256 rungs=8
adaptive=8 limiter=4``) adds Saitoh & Makino's timestep limiter: every
particle's step within a factor A of its neighbours', and the wake-up of
sleeping neighbours of a closing particle; it needs ``rungs=B > 1`` and one
device (``shards=`` refuses it). It
needs the window engine without self-gravity or OU driving, and a run
aborts when more than a quarter of a chunk's closings wanted a dt below the
span's. On the CPU one device refuses every problem (all but ``turb`` take
the dense engine or the cell list there, and ``turb`` is driven);
``shards=N`` always runs the window engine, so ``sedov``, ``kh`` and ``sod``
take rungs there.

A run with P3M gravity on a box periodic on every axis records as
``e_grav`` the potential that P3M solves (``pm.p3m_energy``: the mesh's
potential plus the screened pairs within the window's cutoff, in O(N log
N)), not the direct sum over every pair that other runs with gravity
record. A window-engine run with P3M gravity logs ``mesh_fb`` in each
record: the rows that would fall back from the sorted-order mesh
(``wengine.mesh_fallback_count``), as the JAX CLI does, counted outside
the record's ``particle_steps_per_sec``. The run itself takes the scatter
mesh (``pm.mesh_accel``), the cheaper one on a card, which drops no row:
so unlike the JAX CLI it does not abort on the sorted mesh's dropped rows.
Differences from the JAX CLI:

- every fixed-cadence chunk is a whole number of rebuild periods (2
  steps), an adaptive chunk any number, a rung chunk a whole number of
  spans, and the last chunk is clamped to ``max_steps``: ``max_steps=K``
  runs K steps, K + 1 for an odd K at the fixed cadence, K rounded up to
  whole spans with ``rungs=B`` (the JAX CLI runs whole chunks past it);
- bool overrides parse 0/1, true/false, yes/no, on/off, and raise on
  anything else (the JAX CLI reads ``h_predict=false`` as True);
- ``profile=1`` traces the first chunk of the loop with ``torch.profiler``
  (``out/trace/trace.json``) and counts it in t and step; the trace's host
  timeline carries the program's spans (``io.metrics.SPANS``):
  ``sphax_torch.step`` or ``sphax_torch.tick`` around each step or tick,
  ``sphax_torch.build`` around each window build, ``sphax_torch.derived``
  around each derived pass, and ``sphax_torch.kernel_a`` and
  ``sphax_torch.kernel_c`` around the wrappers of kernels A and C. Without
  a profiler no span is entered, so tracing costs nothing measurable;
- with ``rungs=B`` and ``adaptive=K`` each record carries ``rebuilds``, as
  the global-dt adaptive loop's do;
- ``plot=1`` (``diag.plots``: a Sod or Sedov profile or a slice, and the
  metrics history, as PNGs at the end of the run) raises before the run
  where matplotlib does not import (the card's machine has none), and is
  refused with ``shards=N`` and ``shards=AxB`` (the JAX CLI ignores it
  there);
- a malformed ``shards`` (``0x2``, ``2xb``) raises SystemExit naming it.

``shards=N`` (N > 1) runs the slab decomposition (``sphax_torch.dist``):
this process builds the kernels and the problem (a resume loads its
checkpoint here), splits the particles into N slabs, then spawns N ranks on
the same device that talk over gloo (on a card the ranks share it), each
handed its slab's rows. Every rank runs the window engine on its slab with
two-phase ghosts; ``rebuild_every=K`` (default 2) is the structure's
reuse cadence, ``adaptive=K`` its drift gate. After each chunk the cuts are
rebalanced and particles migrate. Rank 0 logs the all-reduced metrics
(each chunk's record also carries ``chunk``: its builds, host-staged bytes,
kernel launches, and wall, rebalance and migration ms over the ranks),
writes snapshots and the gathered checkpoint (``extra={"shards": "N"}``);
a resume re-distributes the checkpoint. ``profile=1`` is refused with
shards. ``shards=N rungs=B`` runs block timesteps on every rank
(``dist.wrungs``): whole spans a chunk, the cuts rebalanced on the
expected work, and each record carries ``dt_viol`` and ``active_frac``
(its ``chunk`` also the work imbalance before and after the rebalance).

``shards=AxB`` runs the 2D pencil decomposition (``dist.pencil``) on A x B
ranks the same way: two-hop ghosts (x faces, then y faces from the combined
rows), per-axis count rebalancing and migration, and each chunk's record
also carries the host-staged bytes by grid axis and the count imbalance
before and after the rebalance; the checkpoint records
``extra={"shards": "AxB"}``. ``shards=AxB rungs=B`` runs block timesteps
on the pencils (``dist.prungs``). ``adaptive=K`` is refused with pencils,
as in the JAX CLI (the pencil loop keeps the fixed cadence); ``shards=1x1``
is one device.
"""
from __future__ import annotations

import contextlib
import os
import sys

import numpy as np
import torch


def _parse(argv):
    from sphax_torch.problems import REGISTRY

    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        print("problems:", ", ".join(REGISTRY))
        raise SystemExit(0)
    name, kv = argv[0], {}
    if name not in REGISTRY:
        raise SystemExit(f"unknown problem {name!r}; problems: "
                         f"{', '.join(REGISTRY)}")
    for a in argv[1:]:
        k, _, v = a.partition("=")
        try:
            kv[k] = int(v)
        except ValueError:
            try:
                kv[k] = float(v)
            except ValueError:
                kv[k] = v
    return name, kv


def _parse_shards(kv, profile: int, plot: int, adaptive: int):
    """Pop ``shards``: N (slabs) or AxB (pencils, returned as (A, B); 1x1
    is one device, as in the JAX CLI). Raise SystemExit for a malformed
    value and for what the distributed loop does not run."""
    raw = str(kv.pop("shards", 1))
    parts = raw.split("x")
    if len(parts) > 2 or not all(p.isdigit() and int(p) >= 1
                                 for p in parts):
        raise SystemExit(f"shards={raw}: expected N (slabs) or AxB "
                         "(pencils) with N, A, B >= 1")
    shards = (int(parts[0]) if len(parts) == 1
              else (int(parts[0]), int(parts[1])))
    n_dev = shards[0] * shards[1] if isinstance(shards, tuple) else shards
    if n_dev == 1:
        shards = 1
    if isinstance(shards, tuple) and adaptive:
        raise SystemExit(
            "adaptive is wired for shards=N (wslab/wrungs: the drift gate "
            "is a MAX all-reduced scalar); the pencil twin keeps fixed "
            "cadence: use 1D slabs or drop adaptive=")
    if n_dev > 1 and profile:
        raise SystemExit("profile=1 traces the single-device loop only")
    if n_dev > 1 and plot:
        raise SystemExit("plot=1 plots the single-device run only")
    if plot:
        try:
            import matplotlib  # noqa: F401
        except ImportError:
            raise SystemExit("plot=1 needs matplotlib, which this Python "
                             "cannot import; run without plot=1") from None
    if n_dev == 1 and int(kv.get("rebuild_every", 2)) != 2:
        raise SystemExit("rebuild_every: the single-device loop rebuilds "
                         "the window structure every 2 steps")
    return shards


def rung_chunk(prob, state, n_rungs: int, chunk: int, adaptive: int = 0):
    """One chunk of the block-timestep loop on the problem ``prob``:
    ceil(chunk / 2^(n_rungs-1)) whole spans from ``state``, with the
    timestep limiter the problem carries (``prob.rung_limiter``, A; 0 runs
    none). Returns (state, dts, overflow, dt_viol, active_frac, builds):
    ``dt_viol`` the closings that wanted a dt below their span's dt_min,
    ``active_frac`` the closing particles per tick over N (the limiter's
    shorter steps and wake-ups count where they close). The CFL safety
    factor absorbs a few such closings; a persistent rate means the rung
    ladder is too deep for the problem, so above 25 % of the closings this
    raises rather than integrate past the CFL condition, and above 5 % it
    warns."""
    from sphax_torch.integrate import rungs

    span = 1 << (n_rungs - 1)
    nspans = max(1, -(-chunk // span))
    state, dts, nacts, ovf, viol, builds = rungs.simulate_rungs(
        state, prob.cfg, prob.domain, prob.wspec, nspans, n_rungs=n_rungs,
        rebuild_every=2 if span % 2 == 0 else 1, adaptive_rebuild=adaptive,
        limiter=prob.rung_limiter)
    tot, viol = int(nacts.sum()), int(viol)
    if viol > 0.25 * tot:
        raise RuntimeError(
            f"{viol} dt-violating closings in a chunk of {tot} active "
            "closings (> 25%); the rung span outruns the CFL condition: "
            "use fewer rungs")
    if viol > 0.05 * tot:
        print(f"  warning: {viol} dt-violating closings (dt wanted < span "
              "dt_min): consider fewer rungs")
    return state, dts, ovf, viol, tot / (state.n * len(nacts)), builds


def main(argv=None):
    """Run the CLI; returns the final (state, t, step), with state None
    for a distributed run (its checkpoint holds the gathered state)."""
    name, kv = _parse(sys.argv[1:] if argv is None else argv)

    out = kv.pop("out", f"runs/{name}")
    t_end = kv.pop("t_end", None)
    chunk = int(kv.pop("chunk", 16))
    metrics_every = int(kv.pop("metrics_every", 1))   # in chunks
    snapshot_every = int(kv.pop("snapshot_every", 0))  # in chunks; 0 = off
    checkpoint_every = int(kv.pop("checkpoint_every", 8))
    resume = kv.pop("resume", None)
    profile = int(kv.pop("profile", 0))
    # plot=1: profile or slice plots and the metrics history as PNGs at the
    # end of the run (needs matplotlib)
    plot = int(kv.pop("plot", 0))
    # max_steps=K: stop after K steps even if t_end is not reached (0 = off)
    max_steps = int(kv.pop("max_steps", 0))
    # adaptive=K: drift-gated window rebuilds, at most K steps of staleness
    # (0: every 2 steps)
    adaptive = int(kv.pop("adaptive", 0))
    # rungs=B > 1: block timesteps on B rungs (window engine, no gravity or
    # driving)
    n_rungs = int(kv.pop("rungs", 1))
    device = torch.device(str(kv.pop("device", "cuda")))
    shards = _parse_shards(kv, profile, plot, adaptive)
    rebuild_every = int(kv.pop("rebuild_every", 2))
    if chunk < 1 or rebuild_every < 1:
        raise SystemExit("chunk and rebuild_every must be >= 1")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device is visible; device=cpu runs on "
                             "the CPU")
    if shards != 1:
        from sphax_torch.dist.runner import main_dist

        t, step = main_dist(dict(
            name=name, kv=kv, shards=shards, device=str(device), out=out,
            t_end=t_end, chunk=chunk, metrics_every=metrics_every,
            snapshot_every=snapshot_every, checkpoint_every=checkpoint_every,
            resume=resume, max_steps=max_steps, adaptive=adaptive,
            rebuild_every=rebuild_every, n_rungs=n_rungs))
        return None, t, step
    if device.type == "cuda":
        # the driving force's matmul runs in full fp32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    from sphax_torch.io import checkpoint, metrics
    from sphax_torch.physics import wengine
    from sphax_torch.problems import REGISTRY
    from sphax_torch.run import simulate

    prob = REGISTRY[name](device=device, **kv)
    t_end = float(t_end) if t_end is not None else prob.t_end
    os.makedirs(out, exist_ok=True)
    log = metrics.MetricsLogger(os.path.join(out, "metrics.jsonl"))

    state, drive, t, step = prob.state, prob.drive, 0.0, 0
    if resume:
        state, t, step, drive, _ = checkpoint.load(
            str(resume), device=device, dtype=prob.state.pos.dtype)
        if prob.drive_spec is not None and drive is None:
            raise SystemExit(f"{resume} holds no driving state for {name}")
        print(f"resumed from {resume}: t={t:.4f} step={step}")
    driven = prob.drive_spec is not None

    card = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"[{name}] N={state.n} dim={state.dim} t_end={t_end} "
          f"device={card} engine={prob.engine_name}")

    gated = adaptive > 0 and prob.wspec is not None
    if n_rungs > 1 and (prob.wspec is None or prob.cfg.gravity or driven):
        raise SystemExit(
            "rungs>1 needs the window engine without self-gravity or OU "
            "driving (see sphax_torch/integrate/rungs.py scope); on the CPU "
            "the problems take the dense engine or the cell list")
    if prob.rung_limiter and n_rungs == 1:
        raise SystemExit(f"limiter={prob.rung_limiter} limits block "
                         "timesteps: give rungs=B > 1")
    rung_info = {}

    def run_chunk(state, drive, nsteps):
        """(state, drive, dts, overflow, builds of the chunk)."""
        if n_rungs > 1:
            state, dts, ovf, viol, frac, builds = rung_chunk(
                prob, state, n_rungs, nsteps, adaptive)
            rung_info.update(dt_viol=viol, active_frac=frac)
            return state, drive, dts, ovf, builds if gated else None
        if driven:
            prob.noise.reseed(prob.seed, step)
        if prob.wspec is not None:
            out = wengine.simulate(state, prob.cfg, prob.domain, prob.wspec,
                                   nsteps, drive=drive,
                                   drive_spec=prob.drive_spec,
                                   noise=prob.noise,
                                   adaptive_rebuild=adaptive)
            return out if gated else (*out, None)
        st, drive, dts = simulate(state, prob.cfg, prob.domain, prob.engine,
                                  nsteps, drive, prob.drive_spec,
                                  noise=prob.noise)
        return st, drive, dts, 0, None

    def save_checkpoint():
        checkpoint.save(os.path.join(out, "checkpoint.npz"), state, t, step,
                        drive if driven else None, seed=prob.seed)

    # a periodic P3M run's records take the P3M potential, its short range
    # within the window's cutoff (conservation.gravitational_energy)
    record_kw = dict(domain=prob.domain,
                     cutoff=prob.wspec.cutoff if prob.wspec else None)
    nchunks = 0
    while t < t_end and not (max_steps and step >= max_steps):
        nsteps = min(chunk, max_steps - step) if max_steps else chunk
        if not gated and n_rungs == 1:
            nsteps += nsteps % 2             # whole rebuild periods
        trace = (metrics.profile_trace(os.path.join(out, "trace"))
                 if profile and nchunks == 0 else contextlib.nullcontext())
        with trace:
            state, drive, dts, ovf, builds = run_chunk(state, drive, nsteps)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        t += float(torch.sum(dts))
        step += len(dts)
        nchunks += 1
        if int(ovf):
            # a saturated window structure silently deletes pairs
            raise RuntimeError(
                f"window structure overflow ({int(ovf)}) during chunk "
                f"ending at step {step}; re-plan with larger wseg/ghost "
                "capacities")
        if nchunks % metrics_every == 0:
            extra = {}
            if prob.wspec is not None:
                # structural h-cap saturation: silent physics change if > 0
                extra["h_capped"] = int(wengine.capped_count(state,
                                                             prob.wspec))
                if prob.cfg.gravity and prob.cfg.grav_solver == "p3m":
                    # the JAX CLI's metric, for the sorted-order mesh the
                    # run does not take: logged, not timed, not a gate
                    with log.untimed():
                        n_fb, _ = wengine.mesh_fallback_count(
                            state, prob.cfg, prob.domain, prob.wspec)
                        extra["mesh_fb"] = int(n_fb)
            if gated:
                extra["rebuilds"] = builds
            extra.update(rung_info)
            rec = log.log(state, prob.cfg, t, step, **record_kw, **extra)
            capmsg = (f" h_capped={extra['h_capped']}"
                      if extra.get("h_capped") else "")
            if gated:
                capmsg += f" rebuilds={builds}"
            if n_rungs > 1:
                capmsg += (f" active_frac={rung_info['active_frac']:.2f}"
                           f" dt_viol={rung_info['dt_viol']}")
            print(f"  t={t:.4f} step={step} "
                  f"pss={rec['particle_steps_per_sec']:.3e} "
                  f"E={rec['e_total']:.5f} mach={rec['mach_rms']:.2f}"
                  + capmsg)
            if not rec["finite"]:
                bad = checkpoint.verify_integrity(state)
                raise RuntimeError(f"state corrupt at step {step}: {bad}")
        if snapshot_every and nchunks % snapshot_every == 0:
            np.savez_compressed(
                os.path.join(out, f"snap_{step:07d}.npz"),
                **{k: getattr(state, k).cpu().numpy()
                   for k in ("pos", "vel", "rho", "u")}, t=t)
        if checkpoint_every and nchunks % checkpoint_every == 0:
            save_checkpoint()

    save_checkpoint()
    if plot:
        _plot(name, state, prob.cfg, t, out)
    rec = log.log(state, prob.cfg, t, step, **record_kw)
    print(f"done: t={t:.4f} steps={step}; final E={rec['e_total']:.6f}; "
          f"checkpoint + metrics in {out}/")
    return state, t, step


def _plot(name, state, cfg, t, out):
    """plot=1: the JAX CLI's plots of the final state and the run's
    metrics (``diag.plots``)."""
    from sphax_torch.diag import plots

    if name == "sod":
        plots.sod_profile(state, t, os.path.join(out, "profile.png"),
                          gamma=cfg.gamma)
    elif name == "sedov":
        plots.sedov_profile(state, t, os.path.join(out, "profile.png"),
                            gamma=cfg.gamma)
    else:
        plots.slice_2d(state, os.path.join(out, "slice.png"),
                       title=f"{name} t={t:.3f}")
    plots.metrics_history(os.path.join(out, "metrics.jsonl"),
                          os.path.join(out, "history.png"))
    print(f"plots written to {out}/")


if __name__ == "__main__":
    main()
