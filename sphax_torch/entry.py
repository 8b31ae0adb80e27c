"""Entry points, the torch twins of ``__graft_entry__``'s.

``entry(device, dtype, n_side)`` returns ``(fn, (state,))``: ``fn`` is one
full KDK step of the flagship model, exactly as ``__graft_entry__.entry()``
builds it. The turbulence lattice at ``n_side``^3 (16^3 = 4,096 particles),
``configs.TURB`` unchanged (6 Newton updates, Balsara, isothermal), the
window plan measured at h_max = 1.3 max h with cutoff_scale 1.25, one
derived pass, then ``leapfrog.step`` through ``wengine.update_derived``:
kernels A and C once each a call on a card, their plain versions on CPU
tensors. It runs on the card unless the caller passes ``device="cpu"``;
with no card visible it raises. ``fn`` is eager (no ``torch.compile``, no
CUDA graph); its ``cfg``, ``domain`` and ``spec`` attributes are the
step's.

    python -c "from sphax_torch.entry import entry; fn, (s,) = entry(); fn(s)"

``dryrun_multichip(n_ranks, device)`` drives every topology of the
distributed layer once on small shapes, on ``n_ranks`` ranks over gloo
(``dist.comm.launch``; on a card they share it):

  1. the slab decomposition (``dist.wslab``): wseg refined to the measured
     run, a 2-step chunk at ``rebuild_every=2`` (a build step and a reuse
     step), a count rebalance and migration to convergence;
  2. block timesteps on the slabs (``dist.wrungs``): one B = 2 span on the
     same state and cuts;
  3. with 4 or more ranks, the 2D pencil decomposition (``dist.pencil``):
     a 2-step chunk on a 2x2 grid (4 ranks of their own) with its own 12^3
     state.

It asserts what the JAX dry run asserts: health 0, no particle lost,
finite density, dts > 0, some closing particle in the rung span. The
flagship problem is the driven-turbulence lattice (``configs.TURB``,
Newton warm-started with one update) at ceil(3.8 n_ranks)^3 particles in
fp32, its derived fields from one single-device cell-list pass
(``clist.update_derived`` on the flagship's grid), as in the JAX dry run.

    python -c "from sphax_torch.entry import dryrun_multichip; \\
        dryrun_multichip(4, 'cpu')"
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from sphax_torch import configs, convert
from sphax_torch.core.state import box, make_state
from sphax_torch.dist import comm as comm_mod
from sphax_torch.dist import pencil, wrungs, wslab
from sphax_torch.ics import turbulence
from sphax_torch.integrate import leapfrog
from sphax_torch.neighbors import window as win
from sphax_torch.neighbors.cell_list import choose_grid
from sphax_torch.physics import clist, wengine


def _entry_flagship(n_side: int, dtype, device):
    """(state, cfg, domain, grid) of ``__graft_entry__._flagship``: the
    turbulence lattice and ``configs.TURB`` as they stand, and the cell
    grid at h_max = max h."""
    ic = turbulence.build(n_side=n_side)
    kw = dict(dtype=dtype, device=device)
    dom = box(torch.zeros(3, **kw), torch.as_tensor(ic["box"], **kw))
    st = make_state(*(torch.as_tensor(ic[k], **kw)
                      for k in ("pos", "vel", "mass", "u", "h")))
    grid = choose_grid(dom, h_max=float(st.h.max()), n=st.n)
    return st, configs.TURB, dom, grid


def entry(device="cuda", dtype=torch.float32, n_side: int = 16):
    """(fn, (state,)): one full KDK step of the flagship model and its
    example input, the state after one derived pass (module docstring)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("entry() runs on a CUDA device and none is "
                           "visible; pass device='cpu' to run on the CPU")
    st, cfg, dom, _ = _entry_flagship(n_side, dtype, device)
    spec = win.plan_measured(st.pos, dom, h_max=float(st.h.max()) * 1.3,
                             dim=3, cutoff_scale=1.25)

    def engine(s):
        return wengine.update_derived(s, cfg, dom, spec)

    def fn(state):
        return leapfrog.step(state, cfg, dom, engine)[0]

    fn.cfg, fn.domain, fn.spec = cfg, dom, spec
    return fn, (engine(st),)


def _dryrun_flagship(n_side: int, device):
    """(state with its derived fields, cfg, domain) of the dry run's
    turbulence lattice: fp32, Newton warm-started with one update, one
    cell-list pass on the flagship's grid."""
    st, cfg, dom, grid = _entry_flagship(n_side, torch.float32, device)
    cfg = dataclasses.replace(cfg, newton_iters=1)
    return clist.update_derived(st, cfg, dom, grid), cfg, dom


def _rows(shards):
    return {k: np.concatenate([s[k] for s in shards]) for k in shards[0]}


def _rank(c, slab, pen):
    """One rank of the dry run: ``slab`` (topologies 1 and 2) and ``pen``
    (topology 3, on a 2x2 grid) are their arguments, or None. Rank 0
    returns the records."""
    out = {}
    if slab is not None:
        out["slab"] = _slab_part(c, *slab)
    if pen is not None:
        out["pencil"] = _pencil_part(c, *pen)
    return out if c.rank == 0 else None


def _slab_part(c, rows, domain, cfg, spec, cuts, n_real):
    """Topologies 1 and 2 on one rank; its record."""
    dev = c.device
    st = convert.shard_from_numpy(rows, spec, c.rank, dev, torch.float32)
    dom = convert.domain_from_numpy(*domain, device=dev, dtype=torch.float32)
    mr, gdrop = wslab.max_run(c, st, cuts, dom, spec)
    assert gdrop == 0, "ghost capacity exceeded at setup"
    spec = wslab.refine_wseg(spec, mr, headroom=1.3)
    st, _, dts, health, _ = wslab.chunk(c, st, cuts, dom, cfg, spec, 2,
                                        rebuild_every=2)
    assert not bool(health.any()), f"slab health {health.tolist()}"
    assert bool((dts > 0).all())
    cuts = wslab.rebalance_cuts(wslab.histogram(c, st, dom, spec), spec)
    for passes in range(1, c.world + 1):
        st, dropped = wslab.migrate(c, st, cuts, dom, spec)
        assert int(dropped) == 0, "migration dropped particles"
        if wslab.misplaced(c, st, cuts, dom, spec) == 0:
            break
    else:
        raise AssertionError("migration did not converge")
    got = wslab.gather_real(c, st)
    if c.rank == 0:
        assert got.n == n_real, f"lost particles: {got.n} != {n_real}"
        assert bool(torch.isfinite(got.rho).all()), "non-finite density"
    st_r, dts_r, nacts, health_r, _, _ = wrungs.chunk_rungs(
        c, st, cuts, dom, cfg, spec, 1, n_rungs=2, rebuild_every=1)
    assert not bool(health_r.any()), f"rung health {health_r.tolist()}"
    assert bool((dts_r > 0).all()) and int(nacts.max()) > 0
    return dict(steps=len(dts), dt_last=float(dts[-1]),
                migrate_passes=passes, cuts=np.asarray(cuts).tolist(),
                rung_ticks=len(dts_r), rung_closings=int(nacts.sum()))


def _pencil_part(c, rows, domain, cfg, spec, cuts, n_real):
    """Topology 3 on one rank of the 2x2 grid; its record."""
    c.grid(spec.ns0, spec.ns1)
    dev = c.device
    st = convert.shard_from_numpy(rows, spec, c.rank, dev, torch.float32)
    dom = convert.domain_from_numpy(*domain, device=dev, dtype=torch.float32)
    mr, gdrop = pencil.max_run(c, st, *cuts, dom, spec)
    assert gdrop == 0, "pencil ghost capacity exceeded at setup"
    spec = pencil.refine_wseg(spec, mr, headroom=1.3)
    st, _, dts, health, _ = pencil.chunk(c, st, *cuts, dom, cfg, spec, 2,
                                         rebuild_every=2)
    assert not bool(health.any()), f"pencil health {health.tolist()}"
    assert bool((dts > 0).all())
    got = wslab.gather_real(c, st)
    if c.rank == 0:
        assert got.n == n_real, f"lost particles: {got.n} != {n_real}"
        assert bool(torch.isfinite(got.rho).all()), "non-finite density"
    return dict(n=n_real, steps=len(dts))


def dryrun_multichip(n_ranks: int, device="cuda", timeout: float = 300.0):
    """Run the three topologies on ``n_ranks`` ranks on ``device`` (see the
    module docstring); raises on any failed check. Returns the record it
    prints."""
    device = torch.device(device)
    if device.type == "cuda":
        from sphax_torch import _build

        _build.load()
    st, cfg, dom = _dryrun_flagship(math.ceil(3.8 * n_ranks), device)
    domain = (dom.lo.cpu().numpy(), dom.hi.cpu().numpy(), dom.periodic)
    spec = wslab.plan(dom, st.n, h_max=float(st.h.max()) * 1.1,
                      n_shards=n_ranks)
    cuts = wslab.equal_cuts(spec.ncell_ax, n_ranks)
    rows = _rows([convert.state_to_numpy(wslab.distribute(st, dom, spec,
                                                          cuts, r))
                  for r in range(n_ranks)])
    slab = (rows, domain, cfg, spec, cuts, st.n)
    pen, msg = None, " (pencil skipped: < 4 ranks)"
    if n_ranks >= 4:
        stp, _, domp = _dryrun_flagship(12, device)
        pspec = pencil.plan(domp, stp.n, h_max=float(stp.h.max()) * 1.1,
                            ns0=2, ns1=2)
        pcuts = (pencil.equal_cuts(pspec.ncell0, 2),
                 pencil.equal_cuts(pspec.ncell1, 2))
        prows = _rows([convert.state_to_numpy(pencil.distribute(
            stp, domp, pspec, *pcuts, r)) for r in range(4)])
        pen = (prows, (domp.lo.cpu().numpy(), domp.hi.cpu().numpy(),
                       domp.periodic), cfg, pspec, pcuts, stp.n)
        msg = f", pencil 2x2 chunk OK (N={stp.n})"

    def run(world, *jobs):
        return comm_mod.launch(_rank, world, device, "gloo", timeout=timeout,
                               args=jobs)

    # on 4 ranks one launch runs all three (a launch's start-up is most of
    # a dry run on a card); on more, the pencil takes 4 of its own
    rec = (run(4, slab, pen) if n_ranks == 4
           else {**run(n_ranks, slab, None),
                 **(run(4, None, pen) if pen else {})})
    rec.update(n_ranks=n_ranks, n=st.n)
    s = rec["slab"]
    print(f"dryrun_multichip OK: {n_ranks} ranks (window engine), N={st.n}, "
          f"{s['steps']} steps (rebuild_every=2), dt_last={s['dt_last']:.3e},"
          f" migrated to convergence ({s['migrate_passes']} passes), "
          f"rebalanced; rung span B=2 OK ({s['rung_ticks']} ticks, active "
          f"{s['rung_closings']}){msg}", flush=True)
    return rec
