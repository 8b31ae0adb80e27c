"""Scripted slab and pencil runs for the tests and ``chip_smoke.py``:
``lockstep`` (slabs), ``pencil_lockstep`` (pencils) and
``eq_slab_lockstep`` (the equal-extent slabs of ``dist.slab``) interpret a
list of ops on a distributed state and return every state after them, and
``kernel_calls`` records what one derived pass hands kernels A and C. All
are rank programs of ``sphax_torch.dist.comm.launch`` (or called inside
one); this module imports no JAX."""
from __future__ import annotations

import numpy as np
import torch

from sphax_torch import convert
from sphax_torch.configs import SPHConfig
from sphax_torch.core.state import Domain, ParticleState
from sphax_torch.dist import pencil, prungs, slab, wrungs, wslab
from sphax_torch.physics import window_kernels as wk


def lockstep(comm, rows: dict, domain, cfg: SPHConfig,
             spec: wslab.WSlabSpec, cuts, ops, drive=None,
             refine: bool = False):
    """Run ``ops`` on a distributed state in fp64 and return, on rank 0, one
    record per op with the whole sharded state after it.

    ``rows``: the [n_shards * n_local] sharded layout (NumPy, every
    ParticleState field; ``convert.shard_from_numpy``); ``domain`` = (lo,
    hi, periodic). ``refine`` first resizes the spec's wseg to the
    measured ``max_run``, as ``SlabRun`` does. ``ops``:

    - ("step",): one ``wslab.step``;
    - ("chunk", nsteps, rebuild_every, adaptive[, driven]): one
      ``wslab.chunk``, driven when ``driven`` is true: ``drive`` =
      (DriveSpec, amp_re, amp_im, draws) gives the first amplitudes and
      the standard normals (one pair per driven step);
    - ("rungs", nspans, n_rungs, rebuild_every, adaptive): one
      ``wrungs.chunk_rungs``;
    - ("rebalance",): new cuts from the histogram; ("rebalance", B): from
      the work histogram of B rungs (``wslab.work_histogram``);
    - ("work", B): the ranks' expected work (``wslab.shard_work``);
    - ("refine",): wseg resized to the measured ``max_run`` under the
      present cuts;
    - ("migrate",): migration passes until nothing is misplaced;
    - ("reset",): back to the first state and cuts.

    Each record holds the op, its dts, health and builds where it has
    them, a rung chunk's closings per tick and dt violations, the work
    histogram of a work rebalance, the ranks' work, the migration passes,
    the cuts after it, the driving amplitudes after a driven chunk and
    ``rows``, the sharded layout after it."""
    dev, dtype = comm.device, torch.float64
    st = convert.shard_from_numpy(rows, spec, comm.rank, dev, dtype)
    dom = convert.domain_from_numpy(*domain, device=dev, dtype=dtype)
    cuts = np.asarray(cuts)
    if refine:
        mr, gdrop = wslab.max_run(comm, st, cuts, dom, spec)
        if gdrop:
            raise RuntimeError(f"{gdrop} ghosts dropped at setup")
        spec = wslab.refine_wseg(spec, mr)
    st0, cuts0 = st, cuts
    dspec = dr = noise = None
    if drive is not None:
        dspec, dr, noise = _noise_from(drive, dev, dtype)
    recs = []
    for op in ops:
        rec = {"op": op}
        if op[0] == "step":
            st, dt, health = wslab.step(comm, st, cuts, dom, cfg, spec)
            rec.update(dts=dt.reshape(1).cpu().numpy(),
                       health=health.cpu().numpy())
        elif op[0] == "chunk":
            nsteps, rebuild_every, adaptive = op[1:4]
            driven = len(op) > 4 and op[4]
            st, dr_new, dts, health, builds = wslab.chunk(
                comm, st, cuts, dom, cfg, spec, nsteps,
                rebuild_every=rebuild_every, drive=dr if driven else None,
                drive_spec=dspec if driven else None, noise=noise,
                adaptive_rebuild=adaptive)
            rec.update(dts=dts.cpu().numpy(), health=health.cpu().numpy(),
                       builds=builds)
            if driven:
                dr = dr_new
                rec["drive"] = (dr.amp_re.cpu().numpy(),
                                dr.amp_im.cpu().numpy())
        elif op[0] == "rungs":
            nspans, n_rungs, rebuild_every, adaptive = op[1:5]
            st, dts, nacts, health, viol, builds = wrungs.chunk_rungs(
                comm, st, cuts, dom, cfg, spec, nspans, n_rungs=n_rungs,
                rebuild_every=rebuild_every, adaptive_rebuild=adaptive)
            rec.update(dts=dts.cpu().numpy(), health=health.cpu().numpy(),
                       builds=builds, nacts=nacts.cpu().numpy(),
                       dt_viol=int(viol))
        elif op[0] == "reset":
            st, cuts = st0, cuts0
        elif op[0] == "rebalance":
            if len(op) > 1:
                hist = wslab.work_histogram(comm, st, dom, spec, cfg, op[1])
                rec["hist"] = hist
            else:
                hist = wslab.histogram(comm, st, dom, spec)
            cuts = wslab.rebalance_cuts(hist, spec)
        elif op[0] == "refine":
            mr, gdrop = wslab.max_run(comm, st, cuts, dom, spec)
            if gdrop:
                raise RuntimeError(f"{gdrop} ghosts dropped")
            spec = wslab.refine_wseg(spec, mr)
        elif op[0] == "work":
            rec["work"] = wslab.shard_work(comm, st, cfg, op[1])
        elif op[0] == "migrate":
            for k in range(comm.world):
                st, dropped = wslab.migrate(comm, st, cuts, dom, spec)
                if int(dropped):
                    raise RuntimeError(f"migration dropped {int(dropped)}")
                if wslab.misplaced(comm, st, cuts, dom, spec) == 0:
                    break
            else:
                raise RuntimeError("migration did not converge")
            rec["passes"] = k + 1
        else:
            raise ValueError(f"unknown op {op!r}")
        rec["cuts"] = np.asarray(cuts)
        full = comm.gather_rows(wslab._pack(st))
        if comm.rank == 0:
            rec["rows"] = convert.state_to_numpy(
                wslab._unpack(full, st.dim))
        recs.append(rec)
    return recs if comm.rank == 0 else None


def eq_slab_lockstep(comm, rows: dict, domain, cfg: SPHConfig,
                     spec: slab.DistSpec, ops, dtype=torch.float64):
    """Run ``ops`` on the equal-extent slabs (``dist.slab``) and return, on
    rank 0, one record per op with the whole sharded state after it.

    ``rows``: the [n_shards * n_local] sharded layout (NumPy); ``domain`` =
    (lo, hi, periodic). ``ops``: ("step",) one ``slab.step``; ("chunk", n)
    one ``slab.chunk`` of n steps; ("redistribute",) a wrap and re-shard.
    Each record holds the op, its dts and health where it has them, its
    wall in seconds (the device synchronised) and ``rows``, the sharded
    layout after it; the last record also holds ``real``, the real rows in
    ``slab.gather_real``'s order."""
    import time

    dev = comm.device
    st = convert.shard_from_numpy(rows, spec, comm.rank, dev, dtype)
    dom = convert.domain_from_numpy(*domain, device=dev, dtype=dtype)
    recs = []
    for op in ops:
        rec = {"op": op}
        t0 = time.perf_counter()
        if op[0] == "step":
            st, dt, health = slab.step(comm, st, dom, cfg, spec)
            rec.update(dts=np.atleast_1d(dt.cpu().numpy()),
                       health=health.cpu().numpy())
        elif op[0] == "chunk":
            st, dts, health = slab.chunk(comm, st, dom, cfg, spec, op[1])
            rec.update(dts=dts.cpu().numpy(), health=health.cpu().numpy())
        elif op[0] == "redistribute":
            st = slab.redistribute(comm, st, dom, spec)
        else:
            raise ValueError(f"unknown op {op!r}")
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        rec["seconds"] = time.perf_counter() - t0
        full = comm.gather_rows(wslab._pack(st))
        if comm.rank == 0:
            rec["rows"] = convert.state_to_numpy(
                wslab._unpack(full, st.dim))
        recs.append(rec)
    real = slab.gather_real(comm, st)
    if comm.rank != 0:
        return None
    recs[-1]["real"] = convert.state_to_numpy(real)
    return recs


def _noise_from(drive, dev, dtype):
    """(DriveSpec, DriveState, noise) of ``lockstep``'s ``drive`` tuple."""
    dspec, amp_re, amp_im, draws = drive
    it = iter(draws)

    def noise(shape, dtype_, device):
        return tuple(torch.as_tensor(x, dtype=dtype_, device=device)
                     for x in next(it))
    return dspec, convert.drive_from_numpy(amp_re, amp_im, dev, dtype), noise


def pencil_lockstep(comm, rows: dict, domain, cfg: SPHConfig,
                    spec: pencil.PencilSpec, cuts, ops, drive=None,
                    refine: bool = False):
    """``lockstep`` on the pencil decomposition: ``comm`` is laid out as
    the spec's ``ns0 x ns1`` grid and ``cuts`` = (cuts0, cuts1). ``ops``:

    - ("step",): one ``pencil.step``;
    - ("chunk", nsteps, rebuild_every[, driven]): one ``pencil.chunk``,
      driven as in ``lockstep``;
    - ("rungs", nspans, n_rungs, rebuild_every): one
      ``prungs.chunk_rungs``;
    - ("rebalance",): new cuts from the two marginal histograms (the
      record holds them); ("cuts", cuts0, cuts1): these cuts;
    - ("refine",), ("migrate",), ("reset",): as in ``lockstep``.

    Each record holds the op, its dts, health and builds where it has
    them, a rung chunk's closings per tick and dt violations, the
    histograms, the migration passes, the cuts after it (a pair), the
    driving amplitudes after a driven chunk and ``rows``, the sharded
    layout after it."""
    comm.grid(spec.ns0, spec.ns1)
    dev, dtype = comm.device, torch.float64
    st = convert.shard_from_numpy(rows, spec, comm.rank, dev, dtype)
    dom = convert.domain_from_numpy(*domain, device=dev, dtype=dtype)
    c0, c1 = (np.asarray(c) for c in cuts)
    if refine:
        mr, gdrop = pencil.max_run(comm, st, c0, c1, dom, spec)
        if gdrop:
            raise RuntimeError(f"{gdrop} ghosts dropped at setup")
        spec = pencil.refine_wseg(spec, mr)
    first = st, c0, c1
    dspec = dr = noise = None
    if drive is not None:
        dspec, dr, noise = _noise_from(drive, dev, dtype)
    recs = []
    for op in ops:
        rec = {"op": op}
        if op[0] == "step":
            st, dt, health = pencil.step(comm, st, c0, c1, dom, cfg, spec)
            rec.update(dts=dt.reshape(1).cpu().numpy(),
                       health=health.cpu().numpy())
        elif op[0] == "chunk":
            nsteps, rebuild_every = op[1:3]
            driven = len(op) > 3 and op[3]
            st, dr_new, dts, health, builds = pencil.chunk(
                comm, st, c0, c1, dom, cfg, spec, nsteps,
                rebuild_every=rebuild_every, drive=dr if driven else None,
                drive_spec=dspec if driven else None, noise=noise)
            rec.update(dts=dts.cpu().numpy(), health=health.cpu().numpy(),
                       builds=builds)
            if driven:
                dr = dr_new
                rec["drive"] = (dr.amp_re.cpu().numpy(),
                                dr.amp_im.cpu().numpy())
        elif op[0] == "rungs":
            nspans, n_rungs, rebuild_every = op[1:4]
            st, dts, nacts, health, viol, builds = prungs.chunk_rungs(
                comm, st, c0, c1, dom, cfg, spec, nspans, n_rungs=n_rungs,
                rebuild_every=rebuild_every)
            rec.update(dts=dts.cpu().numpy(), health=health.cpu().numpy(),
                       builds=builds, nacts=nacts.cpu().numpy(),
                       dt_viol=int(viol))
        elif op[0] == "reset":
            st, c0, c1 = first
        elif op[0] == "rebalance":
            rec["hist"] = pencil.histograms(comm, st, dom, spec)
            c0, c1 = pencil.rebalance(*rec["hist"], spec)
        elif op[0] == "cuts":
            c0, c1 = (np.asarray(c) for c in op[1:3])
        elif op[0] == "refine":
            mr, gdrop = pencil.max_run(comm, st, c0, c1, dom, spec)
            if gdrop:
                raise RuntimeError(f"{gdrop} ghosts dropped")
            spec = pencil.refine_wseg(spec, mr)
        elif op[0] == "migrate":
            for k in range(max(spec.ns0, spec.ns1)):
                st, dropped = pencil.migrate(comm, st, c0, c1, dom, spec)
                if int(dropped):
                    raise RuntimeError(f"migration dropped {int(dropped)}")
                if pencil.misplaced(comm, st, c0, c1, dom, spec) == 0:
                    break
            else:
                raise RuntimeError("migration did not converge")
            rec["passes"] = k + 1
        else:
            raise ValueError(f"unknown op {op!r}")
        rec["cuts"] = (np.asarray(c0), np.asarray(c1))
        full = comm.gather_rows(wslab._pack(st))
        if comm.rank == 0:
            rec["rows"] = convert.state_to_numpy(
                wslab._unpack(full, st.dim))
        recs.append(rec)
    return recs if comm.rank == 0 else None


def kernel_calls(comm, st: ParticleState, cuts, domain: Domain,
                 cfg: SPHConfig, spec, close_m=None):
    """One derived pass of this rank on a fresh structure (every rank must
    call it: it exchanges ghosts), recording what it hands kernels A and C:
    ``wslab._local_derived``'s, or with ``close_m`` ([n_local] bool, this
    rank's closers) the rung pass's on the close-masked structure
    (``wrungs._local_derived_rungs``, the viscosity-factor carry at 1). On
    a pencil grid (``spec`` a PencilSpec, ``cuts`` = (cuts0, cuts1),
    ``comm`` laid out as its grid) the pencil twins: ``pencil`` and
    ``prungs``. Returns ({"A": (args, kwargs), "C": (args, kwargs)},
    active_s): the calls' arguments, and the sorted rows that are this
    rank's own real particles (the rows whose outputs the pass keeps)."""
    calls = {}
    # the derived pass reaches both through window_kernels' module globals
    saved = wk.solve_h_density, wk.forces

    def record(name, fn):
        def call(*a, **k):
            calls[name] = (a, k)
            return fn(*a, **k)
        return call

    wk.solve_h_density = record("A", saved[0])
    wk.forces = record("C", saved[1])
    bf = torch.ones_like(st.h)
    try:
        if isinstance(spec, pencil.PencilSpec):
            st = st._replace(pos=pencil._wrap_other(st.pos, domain))
            wd, *built, _ = pencil._exchange_and_build(comm, st, *cuts,
                                                       domain, spec)
            n_ghost = 2 * (spec.ghost_cap0 + spec.ghost_cap1)
            if close_m is None:
                pencil._local_derived(comm, st, wd, *built, cfg, domain,
                                      spec)
            else:
                prungs._local_derived_rungs(comm, st, bf, wd, *built, cfg,
                                            domain, spec, close_m)
        else:
            st = st._replace(pos=wslab._wrap_transverse(st.pos, domain,
                                                        spec.slab_axis))
            wd, routes, slab_lo, _ = wslab._exchange_and_build(
                comm, st, cuts, domain, spec)
            n_ghost = 2 * spec.ghost_cap
            if close_m is None:
                wslab._local_derived(comm, st, wd, routes, slab_lo, cfg,
                                     domain, spec, cuts)
            else:
                wrungs._local_derived_rungs(comm, st, bf, wd, routes,
                                            slab_lo, cfg, domain, spec,
                                            close_m)
    finally:
        wk.solve_h_density, wk.forces = saved
    n = st.n + n_ghost
    own = torch.cat([st.mass > 0, st.mass.new_zeros(n_ghost + 1,
                                                    dtype=torch.bool)])
    return calls, wd.is_real & own[torch.clamp_max(wd.g, n).long()]
