"""One rank's loop of a distributed run (torch twins of
``sphax.dist.runner.SlabRun`` and ``PencilRun``) and the CLI's ``shards=N``
and ``shards=AxB`` (twin of ``sphax.__main__._main_dist``).

``split`` (slabs) and ``split_pencil`` (pencils) run once, in the process
that launches the ranks: plan -> equal cuts -> each rank's rows
(``wslab.distribute``, ``pencil.distribute``). ``SlabRun`` and
``PencilRun`` live in every rank:

    set-up: its rows -> measured wseg refinement
    chunk:  KDK steps with window-structure reuse at ``rebuild_every`` (or,
            on slabs, drift-gated rebuilds), two-phase ring ghosts (two
            hops on pencils), a MIN all-reduced dt, replicated OU driving;
            with ``n_rungs > 1`` whole spans of block timesteps
            (``wrungs.chunk_rungs``, ``prungs.chunk_rungs``)
    after each chunk: cut rebalancing from the all-reduced histograms (of
            counts, or on slabs with rungs of expected work), then
            migration passes until no particle is misplaced
    metrics: all-reduced conservation scalars
    checkpoint: the real rows gathered to rank 0; a resume re-distributes
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from sphax_torch import convert
from sphax_torch.configs import SPHConfig
from sphax_torch.core.state import Domain, ParticleState
from sphax_torch.dist import comm as comm_mod
from sphax_torch.dist import pencil, prungs, wrungs, wslab
from sphax_torch.physics import window_kernels as wk


# h_max of the plan over the state's largest h (the JAX package's default)
H_MARGIN = 1.1


def split(state: ParticleState, domain: Domain, world: int):
    """The decomposition of a single-device state over ``world`` ranks:
    (spec, cuts, rows). The plan takes the production window knobs of the
    single-device engine (fast_sub=3, rgroups=2; a shard box too thin for
    the fine fast-axis grid takes 1 and 1), the cuts are equal, and
    ``rows[r]`` holds rank r's rows (``wslab.distribute``) as NumPy
    arrays, ready for ``convert.state_from_numpy``."""
    h_max = float(state.h.max()) * H_MARGIN
    try:
        spec = wslab.plan(domain, state.n, h_max, world, fast_sub=3,
                          rgroups=2)
    except ValueError:
        spec = wslab.plan(domain, state.n, h_max, world)
    cuts = wslab.equal_cuts(spec.ncell_ax, world)
    rows = [convert.state_to_numpy(wslab.distribute(state, domain, spec,
                                                    cuts, r))
            for r in range(world)]
    return spec, cuts, rows


def split_pencil(state: ParticleState, domain: Domain, ns0: int, ns1: int):
    """``split`` for an ``ns0 x ns1`` pencil grid: (spec, (cuts0, cuts1),
    rows), ``rows[r]`` rank r's pencil (``pencil.distribute``)."""
    h_max = float(state.h.max()) * H_MARGIN
    try:
        spec = pencil.plan(domain, state.n, h_max, ns0, ns1, fast_sub=3,
                           rgroups=2)
    except ValueError:
        spec = pencil.plan(domain, state.n, h_max, ns0, ns1)
    cuts = (pencil.equal_cuts(spec.ncell0, ns0),
            pencil.equal_cuts(spec.ncell1, ns1))
    rows = [convert.state_to_numpy(pencil.distribute(state, domain, spec,
                                                     *cuts, r))
            for r in range(ns0 * ns1)]
    return spec, cuts, rows


class SlabRun:
    """One rank's share of a distributed simulation: its shard of the
    state, the decomposition's spec and cuts, and the chunk loop.

    ``shard`` is this rank's rows, with ``spec`` and ``cuts``, as ``split``
    makes them; ``n_real`` is the particle count over all ranks. ``noise``
    is the rank's OU noise source when ``drive_spec`` is given: every rank
    must draw the same stream. After ``run_chunk``, ``stats`` holds this
    rank's share of the chunk: its steps, builds, wall seconds, host-staged
    bytes, kernel launches (``window_kernels.LAUNCHES`` keys), the
    rebalance's seconds and the migration's passes and seconds.

    ``n_rungs = B > 1`` runs block timesteps on B rungs: a chunk is whole
    spans of 2^(B-1) ticks, ``rebuild_every`` falls to 1 where it does not
    divide the span, and the cuts rebalance on the expected work rather
    than the counts. It needs no driving and no self-gravity. After a rung
    chunk ``last_active_frac`` (closings per tick over N), ``last_dt_viol``
    (the chunk's dt-violating closings) and ``last_rebuilds`` hold its
    counts, and ``stats`` the ranks' work imbalance (max over mean) before
    and after the rebalance and migration."""

    def __init__(self, comm, shard: ParticleState, spec: wslab.WSlabSpec,
                 cuts, n_real: int, cfg: SPHConfig, domain: Domain,
                 chunk_steps: int = 8, rebuild_every: int = 2, drive=None,
                 drive_spec=None, noise=None, n_rungs: int = 1,
                 adaptive_rebuild: int = 0):
        if n_rungs > 1:
            if drive_spec is not None or cfg.gravity:
                raise NotImplementedError(
                    "rungs>1 needs the window engine without self-gravity "
                    "or OU driving (see integrate/rungs.py scope)")
            span = 1 << (n_rungs - 1)
            if span % rebuild_every:
                rebuild_every = 1
            chunk_steps = max(1, -(-chunk_steps // span)) * span
        if not adaptive_rebuild and chunk_steps % rebuild_every:
            chunk_steps += rebuild_every - chunk_steps % rebuild_every
        self.comm, self.cfg, self.domain = comm, cfg, domain
        self.chunk_steps, self.rebuild_every = chunk_steps, rebuild_every
        self.drive, self.drive_spec, self.noise = drive, drive_spec, noise
        self.adaptive_rebuild = adaptive_rebuild
        self.n_rungs = n_rungs
        self.n_real = int(n_real)
        self.stats = {}
        self.last_active_frac = 1.0
        self.last_dt_viol = 0
        self.last_rebuilds = 0
        self.cuts = self._own_cuts(cuts)
        self.state = shard
        mr, gdrop = self._max_run(spec)
        if gdrop:
            raise RuntimeError(f"{gdrop} ghosts dropped at setup; re-plan "
                               "with a larger ghost_safety")
        self.spec = wslab.refine_wseg(spec, mr)

    @staticmethod
    def _own_cuts(cuts):
        return np.asarray(cuts)

    def _max_run(self, spec):
        """(largest window run, ghosts dropped) of the present cuts."""
        return wslab.max_run(self.comm, self.state, self.cuts, self.domain,
                             spec)

    def run_chunk(self, nsteps: int = None):
        """Advance ``nsteps`` steps (default ``chunk_steps``; a whole number
        of rebuild periods at the fixed cadence, rounded up to whole spans
        with rungs), rebalance the cuts and migrate to convergence. Returns
        the dts (a tensor on the rank's device). Raises on any nonzero
        health counter, and with rungs when more than a quarter of the
        chunk's closings wanted a dt below their span's."""
        nsteps = self.chunk_steps if nsteps is None else nsteps
        # start together, so that the chunk's wall is not a wait for a rank
        # that is still writing a checkpoint
        self.comm.barrier()
        staged0 = dict(comm_mod.STAGED)
        launches0 = dict(wk.LAUNCHES)
        t0 = time.perf_counter()
        dts, health, builds, tot = self._advance(nsteps)
        self.last_rebuilds = builds
        dropped, overflow = (int(v) for v in health)
        self.stats = dict(steps=len(dts), builds=builds,
                          chunk_s=time.perf_counter() - t0,
                          staged={k: v - staged0[k]
                                  for k, v in comm_mod.STAGED.items()},
                          launches={k: v - launches0[k]
                                    for k, v in wk.LAUNCHES.items()})
        if dropped:
            raise RuntimeError(f"{dropped} ghosts dropped in chunk; re-plan "
                               "with larger ghost capacity")
        if overflow:
            raise RuntimeError(f"window structure overflow ({overflow}); "
                               "re-plan with larger wseg/ghost capacities")
        if tot is not None and self.last_dt_viol > 0.25 * max(tot, 1):
            raise RuntimeError(
                f"{self.last_dt_viol} dt-violating closings in a chunk of "
                f"{tot} active closings (> 25%); the rung span outruns the "
                "CFL condition: use fewer rungs")
        t0 = time.perf_counter()
        self._rebalance()
        self.stats["rebalance_s"] = time.perf_counter() - t0
        if self.tracks_imbalance:
            self.stats["imbalance_before"] = self.imbalance()
        t0 = time.perf_counter()
        self.stats["migrate_passes"] = self._migrate_to_convergence()
        self.stats["migrate_s"] = time.perf_counter() - t0
        if self.tracks_imbalance:
            self.stats["imbalance_after"] = self.imbalance()
        return dts

    @property
    def tracks_imbalance(self) -> bool:
        """Whether a chunk records the ranks' imbalance (with rungs: the
        rebalance moves the expected work)."""
        return self.n_rungs > 1

    def _rung_counts(self, nacts, viol) -> int:
        """Keep a rung chunk's active fraction and dt violations; returns
        its closings."""
        tot = int(nacts.sum())
        self.last_active_frac = tot / (self.n_real * len(nacts))
        self.last_dt_viol = int(viol)
        return tot

    def _advance(self, nsteps: int):
        """One chunk: (dts, health, builds, closings or None)."""
        if self.n_rungs > 1:
            span = 1 << (self.n_rungs - 1)
            self.state, dts, nacts, health, viol, builds = wrungs.chunk_rungs(
                self.comm, self.state, self.cuts, self.domain, self.cfg,
                self.spec, max(1, -(-nsteps // span)), n_rungs=self.n_rungs,
                rebuild_every=self.rebuild_every,
                adaptive_rebuild=self.adaptive_rebuild)
            return dts, health, builds, self._rung_counts(nacts, viol)
        self.state, self.drive, dts, health, builds = wslab.chunk(
            self.comm, self.state, self.cuts, self.domain, self.cfg,
            self.spec, nsteps, rebuild_every=self.rebuild_every,
            drive=self.drive, drive_spec=self.drive_spec, noise=self.noise,
            adaptive_rebuild=self.adaptive_rebuild)
        return dts, health, builds, None

    def _rebalance(self):
        if self.n_rungs > 1:
            # a tick takes as long as the busiest rank's active walk
            hist = wslab.work_histogram(self.comm, self.state, self.domain,
                                        self.spec, self.cfg, self.n_rungs)
        else:
            hist = wslab.histogram(self.comm, self.state, self.domain,
                                   self.spec)
        self.cuts = wslab.rebalance_cuts(hist, self.spec)

    def imbalance(self) -> float:
        """The ranks' expected work under block timesteps, max over mean
        (``wslab.shard_work``); every rank must call it."""
        w = wslab.shard_work(self.comm, self.state, self.cfg, self.n_rungs)
        return float(w.max() / w.mean())

    def _migrate_pass(self):
        """One migration pass; (dropped, misplaced after it)."""
        self.state, dropped = wslab.migrate(self.comm, self.state, self.cuts,
                                            self.domain, self.spec)
        return int(dropped), wslab.misplaced(self.comm, self.state,
                                             self.cuts, self.domain,
                                             self.spec)

    # a particle k shards from home is resident after k passes
    def _max_passes(self) -> int:
        return self.comm.world

    def _migrate_to_convergence(self) -> int:
        for k in range(self._max_passes()):
            dropped, left = self._migrate_pass()
            if dropped:
                raise RuntimeError(f"migration dropped {dropped} particles; "
                                   "re-plan with a larger migrate_frac")
            if left == 0:
                return k + 1
        raise RuntimeError(f"migration did not converge within "
                           f"{self._max_passes()} passes")

    def metrics(self, t: float) -> dict:
        """The all-reduced conservation and flow record."""
        return wslab.diagnostics(self.comm, self.state, t)

    def chunk_record(self) -> dict:
        """The last chunk's costs over all ranks: builds, host-staged bytes
        (on pencils also by grid axis) and kernel launches summed, wall,
        rebalance and migration milliseconds the slowest rank's, migration
        passes; with rungs also the active fraction and the dt violations;
        and the imbalance (``imbalance``) before and after the rebalance
        where the run tracks it."""
        keys = sorted(wk.LAUNCHES)
        st = self.stats
        dev = self.comm.device
        sums = self.comm.all_reduce_sum(torch.tensor(
            [st["launches"][k] for k in keys]
            + [st["staged"][k] for k in ("bytes", "sx", "sy")],
            dtype=torch.int64, device=dev)).tolist()
        slow = self.comm.all_reduce_max(torch.tensor(
            [st["chunk_s"], st["rebalance_s"], st["migrate_s"]],
            dtype=torch.float64, device=dev)).tolist()
        rec = dict(builds=st["builds"], staged_bytes=sums[-3],
                   chunk_ms=1e3 * slow[0], rebalance_ms=1e3 * slow[1],
                   migrate_ms=1e3 * slow[2],
                   migrate_passes=st["migrate_passes"],
                   launches={k: n for k, n in zip(keys, sums) if n})
        if self.comm.shape is not None:
            rec["staged_bytes_by_axis"] = dict(sx=sums[-2], sy=sums[-1])
        if self.n_rungs > 1:
            rec.update(active_frac=self.last_active_frac,
                       dt_viol=self.last_dt_viol)
        if self.tracks_imbalance:
            rec.update(imbalance_before=st["imbalance_before"],
                       imbalance_after=st["imbalance_after"])
        return rec

    def gather(self):
        """The real rows on rank 0 (None on the others)."""
        return wslab.gather_real(self.comm, self.state)


class PencilRun(SlabRun):
    """One rank's share of a distributed simulation over an ``ns0 x ns1``
    pencil grid (the twin of ``sphax.dist.runner.PencilRun``), with
    ``SlabRun``'s loop and records: ``comm`` is laid out as the spec's
    grid, ``cuts`` = (cuts0, cuts1) as ``split_pencil`` makes them. After
    each chunk the cuts rebalance per axis on the count histograms (with
    rungs too, as the JAX package's does: it does not work-weight) and
    migration takes at most max(ns0, ns1) passes. ``stats`` and the chunk
    record hold the ranks' count imbalance (max over mean) before and
    after the rebalance and migration. Drift-gated rebuilds are the slab
    engine's only."""

    def __init__(self, comm, shard: ParticleState, spec: pencil.PencilSpec,
                 cuts, n_real: int, cfg: SPHConfig, domain: Domain,
                 chunk_steps: int = 8, rebuild_every: int = 2, drive=None,
                 drive_spec=None, noise=None, n_rungs: int = 1):
        super().__init__(comm.grid(spec.ns0, spec.ns1), shard, spec, cuts,
                         n_real, cfg, domain, chunk_steps=chunk_steps,
                         rebuild_every=rebuild_every, drive=drive,
                         drive_spec=drive_spec, noise=noise,
                         n_rungs=n_rungs)

    @staticmethod
    def _own_cuts(cuts):
        return tuple(np.asarray(c) for c in cuts)

    def _max_run(self, spec):
        return pencil.max_run(self.comm, self.state, *self.cuts, self.domain,
                              spec)

    tracks_imbalance = True

    def _advance(self, nsteps: int):
        if self.n_rungs > 1:
            span = 1 << (self.n_rungs - 1)
            self.state, dts, nacts, health, viol, builds = prungs.chunk_rungs(
                self.comm, self.state, *self.cuts, self.domain, self.cfg,
                self.spec, max(1, -(-nsteps // span)), n_rungs=self.n_rungs,
                rebuild_every=self.rebuild_every)
            return dts, health, builds, self._rung_counts(nacts, viol)
        self.state, self.drive, dts, health, builds = pencil.chunk(
            self.comm, self.state, *self.cuts, self.domain, self.cfg,
            self.spec, nsteps, rebuild_every=self.rebuild_every,
            drive=self.drive, drive_spec=self.drive_spec, noise=self.noise)
        return dts, health, builds, None

    def _rebalance(self):
        self.cuts = pencil.rebalance(*pencil.histograms(
            self.comm, self.state, self.domain, self.spec), self.spec)

    def imbalance(self) -> float:
        """The ranks' real particles, max over mean; every rank must call
        it."""
        c = pencil.counts(self.comm, self.state)
        return float(c.max() / c.mean())

    def _migrate_pass(self):
        self.state, dropped = pencil.migrate(self.comm, self.state,
                                             *self.cuts, self.domain,
                                             self.spec)
        return int(dropped), pencil.misplaced(self.comm, self.state,
                                              *self.cuts, self.domain,
                                              self.spec)

    # one x hop and one y hop a pass: (kx, ky) pencils from home takes
    # max(kx, ky) passes
    def _max_passes(self) -> int:
        return max(self.spec.ns0, self.spec.ns1)


# ---------------------------------------------------------------------------
# the CLI's shards=N and shards=AxB
# ---------------------------------------------------------------------------

# seconds any collective of the CLI's ranks may wait for its peers
CLI_TIMEOUT = 900.0


def shard_str(shards) -> str:
    """"N" or "AxB", as the CLI takes it and the checkpoints record it."""
    return "x".join(map(str, shards)) if isinstance(shards, tuple) \
        else str(shards)


def main_dist(opts: dict):
    """``python -m sphax_torch <problem> shards=N`` (or ``shards=AxB``,
    ``opts["shards"]`` then (A, B)): build the kernels and the problem here
    (on the card; a resume loads its checkpoint here), split the state into
    N slabs (A x B pencils), then run that many ranks of ``_cli_rank`` on
    the same device over gloo, each given its own rows. Returns rank 0's
    (t, step)."""
    from sphax_torch.io import checkpoint
    from sphax_torch.problems import REGISTRY

    device = torch.device(opts["device"])
    if device.type == "cuda":
        from sphax_torch import _build

        _build.load()
    name, shards = opts["name"], opts["shards"]
    grid = shards if isinstance(shards, tuple) else None
    n_dev = shards[0] * shards[1] if grid else shards
    prob = REGISTRY[name](device=device, **opts["kv"])
    driven = prob.drive_spec is not None
    if opts["n_rungs"] > 1 and (driven or prob.cfg.gravity):
        raise SystemExit(
            "rungs>1 needs the window engine without self-gravity or OU "
            "driving (see sphax_torch/dist/wrungs.py scope)")
    state, drive, t, step = prob.state, prob.drive, 0.0, 0
    if opts["resume"]:
        state, t, step, drive, _ = checkpoint.load(
            str(opts["resume"]), device=device, dtype=prob.state.pos.dtype)
        if driven and drive is None:
            raise SystemExit(f"{opts['resume']} holds no driving state for "
                             f"{name}")
        print(f"resumed from {opts['resume']}: t={t:.4f} step={step}",
              flush=True)
    t_end = (float(opts["t_end"]) if opts["t_end"] is not None
             else prob.t_end)
    card = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"[{name}] N={state.n} dim={state.dim} t_end={t_end} "
          f"device={card} shards={shard_str(shards)} (ranks over gloo)",
          flush=True)
    try:
        spec, cuts, rows = (split_pencil(state, prob.domain, *grid) if grid
                            else split(state, prob.domain, n_dev))
    except ValueError as e:          # a box too thin for this many shards
        raise SystemExit(f"shards={shard_str(shards)}: {e}") from None
    dom = prob.domain
    setup = dict(
        cfg=prob.cfg, dtype=state.pos.dtype, spec=spec, cuts=cuts,
        n_real=state.n, t=t, step=step, t_end=t_end, seed=prob.seed,
        domain=(dom.lo.cpu().numpy(), dom.hi.cpu().numpy(), dom.periodic),
        drive_spec=prob.drive_spec,
        drive=((drive.amp_re.cpu().numpy(), drive.amp_im.cpu().numpy())
               if driven else None))
    del prob, state, drive, dom
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return comm_mod.launch(_cli_rank, n_dev, device, "gloo",
                           timeout=CLI_TIMEOUT, args=(opts, setup),
                           rank_args=rows)


def _cli_rank(comm, opts, setup, rows):
    """One rank of the CLI's distributed loop (``SlabRun``, or
    ``PencilRun`` for ``shards=AxB``) from ``main_dist``'s ``setup`` and
    this rank's ``rows``; rank 0 logs (each chunk's record carries
    ``chunk``, ``SlabRun.chunk_record``), snapshots and checkpoints."""
    from sphax_torch.io import checkpoint, metrics
    from sphax_torch.physics import driving

    dev = comm.device
    if dev.type == "cuda":
        # the driving force's matmul runs in full fp32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    lead = comm.rank == 0
    name, out, shards = opts["name"], opts["out"], shard_str(opts["shards"])
    dtype, seed = setup["dtype"], setup["seed"]
    t, step, t_end = setup["t"], setup["step"], setup["t_end"]
    dom = convert.domain_from_numpy(*setup["domain"], device=dev,
                                    dtype=dtype)
    driven = setup["drive_spec"] is not None
    drive = noise = None
    if driven:
        drive = convert.drive_from_numpy(*setup["drive"], dev, dtype)
        noise = driving.gaussian_noise(
            torch.Generator(device=dev).manual_seed(seed))
    log = None
    if lead:
        os.makedirs(out, exist_ok=True)
        log = metrics.MetricsLogger(os.path.join(out, "metrics.jsonl"))
    adaptive, rebuild_every = opts["adaptive"], opts["rebuild_every"]
    n_rungs = opts["n_rungs"]
    kw = dict(chunk_steps=opts["chunk"], rebuild_every=rebuild_every,
              drive=drive, drive_spec=setup["drive_spec"], noise=noise,
              n_rungs=n_rungs)
    shard = convert.state_from_numpy(rows, dev, dtype)
    args = (setup["spec"], setup["cuts"], setup["n_real"], setup["cfg"], dom)
    if isinstance(opts["shards"], tuple):
        run = PencilRun(comm, shard, *args, **kw)
    else:
        run = SlabRun(comm, shard, *args, adaptive_rebuild=adaptive, **kw)
    del shard

    def save_checkpoint():
        g = run.gather()
        if lead:
            checkpoint.save(os.path.join(out, "checkpoint.npz"), g, t, step,
                            run.drive if driven else None,
                            extra={"shards": shards}, seed=seed)

    max_steps = opts["max_steps"]
    nchunks = 0
    while t < t_end and not (max_steps and step >= max_steps):
        nsteps = (min(opts["chunk"], max_steps - step) if max_steps
                  else opts["chunk"])
        if not adaptive and n_rungs == 1:
            nsteps += (-nsteps) % rebuild_every   # whole rebuild periods
        if driven:
            noise.reseed(seed, step)
        dts = run.run_chunk(nsteps)
        t += float(torch.sum(dts))
        step += len(dts)
        nchunks += 1
        if nchunks % opts["metrics_every"] == 0:
            rec, costs = run.metrics(t), run.chunk_record()
            if lead:
                extra = ({"dt_viol": run.last_dt_viol,
                          "active_frac": run.last_active_frac}
                         if n_rungs > 1 else {})
                if adaptive:
                    extra["rebuilds"] = run.last_rebuilds
                rec = log.log_record(rec, step, run.n_real, **extra,
                                     chunk=costs)
                rmsg = (f" active_frac={run.last_active_frac:.2f} "
                        f"dt_viol={run.last_dt_viol}," if n_rungs > 1 else "")
                if run.tracks_imbalance:
                    rmsg += (f" {'count' if run.comm.shape else 'work'} "
                             f"imbalance {costs['imbalance_before']:.3f} -> "
                             f"{costs['imbalance_after']:.3f},")
                print(f"  t={t:.4f} step={step} "
                      f"pss={rec['particle_steps_per_sec']:.3e} "
                      f"E={rec['e_total']:.5f} mach={rec['mach_rms']:.2f} "
                      f"[{shards} shards]{rmsg} staged "
                      f"{costs['staged_bytes'] / len(dts):.4g} B/step, "
                      f"migration {costs['migrate_passes']} passes "
                      f"{costs['migrate_ms']:.3g} ms", flush=True)
            if not rec["finite"]:
                g = run.gather()
                bad = checkpoint.verify_integrity(g) if lead else ""
                raise RuntimeError(f"state corrupt at step {step}: {bad}")
        snap = opts["snapshot_every"]
        if snap and nchunks % snap == 0:
            g = run.gather()
            if lead:
                np.savez_compressed(
                    os.path.join(out, f"snap_{step:07d}.npz"),
                    **{k: getattr(g, k).cpu().numpy()
                       for k in ("pos", "vel", "rho", "u")}, t=t)
        ck = opts["checkpoint_every"]
        if ck and nchunks % ck == 0:
            save_checkpoint()

    save_checkpoint()
    rec = run.metrics(t)
    if lead:
        rec = log.log_record(rec, step, run.n_real)
        print(f"done: t={t:.4f} steps={step}; final E={rec['e_total']:.6f}; "
              f"checkpoint + metrics in {out}/ ({shards} shards)", flush=True)
    return t, step
