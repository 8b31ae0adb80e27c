"""The port's slab decomposition against the port's own single-device
window engine, continued from tests/test_torch_wslab_lockstep.py (its
helpers; the ports of tests/dist/test_wslab.py's migration and gravity
tests and of tests/dist/test_dist_adaptive.py): migration and rebalancing
of clustered ICs, ring gravity, P3M, and drift-gated rebuilds against the
fixed cadence, on gloo ranks over CPU tensors at the JAX tests'
tolerances; and a shard's masked structure held to what the CUDA kernels
take.
"""
import dataclasses

import numpy as np
import torch

from sphax_torch import configs as tconf
from sphax_torch.dist import comm
from sphax_torch.dist import wslab as tslab
from sphax_torch.ics import sedov
from sphax_torch.neighbors import window as win
from sphax_torch.physics import wengine
from sphax_torch.physics import window_kernels as wk
from tests.test_torch_wslab_lockstep import (CFGS, _compare, _dist, _lattice,
                                             _real, _single, _state)

torch.set_num_threads(1)


def test_wslab_chunk_migrate_rebalance():
    """Clustered ICs (3/4 of the particles in the left half of the slab
    axis): two chunks, each followed by a rebalance of the cuts from the
    histogram and migration to convergence. The per-shard counts end up
    within 2.5x of each other and clearly better than the equal cuts', mass
    is conserved, and every shard's particles lie inside its slab."""
    cfg = CFGS["fixed_h"]
    rng = np.random.default_rng(7)
    n = 4096
    pos = rng.random((n, 3))
    pos[: 3 * n // 4, 0] *= 0.5
    vel = rng.normal(scale=0.3, size=(n, 3))
    st, dom = _state(pos, vel, np.full(n, 1.0 / n), np.ones(n),
                     np.full(n, 0.042))
    spec1 = win.plan_measured(st.pos, dom, h_max=0.042, dim=3)
    st0 = wengine.update_derived(st, cfg, dom, spec1)
    ns = 4
    ops = [("chunk", 3, 1, 0), ("rebalance",), ("migrate",)] * 2
    recs, spec = _dist(st0, cfg, dom, ns, ops, h_max=0.042, pad_factor=3.2,
                       balance_headroom=2.6)

    def counts(rec):
        m = rec["rows"]["mass"].reshape(ns, spec.n_local) > 0
        c = m.sum(1)
        return c, c.max() / max(c.min(), 1)

    _, imb0 = counts(dict(rows=dict(mass=np.concatenate(
        [tslab.distribute(st0, dom, spec, tslab.equal_cuts(spec.ncell_ax, ns),
                          r).mass.numpy() for r in range(ns)]))))
    for r in recs:
        if "dts" in r:
            assert np.isfinite(r["dts"]).all()
    got = _real(recs[-1])
    assert len(got["mass"]) == n
    assert abs(got["mass"].sum() - 1.0) < 1e-12
    assert np.isfinite(got["rho"]).all()
    c, imb = counts(recs[-1])
    assert imb < 2.5, (c, imb0)
    assert imb < 0.8 * imb0, (c, imb0)
    assert not np.array_equal(recs[-1]["cuts"],
                              tslab.equal_cuts(spec.ncell_ax, ns))
    # every shard's real particles lie in its slab
    cuts, cell = recs[-1]["cuts"], 1.0 / spec.ncell_ax
    x = recs[-1]["rows"]["pos"][:, 0].reshape(ns, spec.n_local)
    m = recs[-1]["rows"]["mass"].reshape(ns, spec.n_local) > 0
    for s in range(ns):
        assert (x[s][m[s]] >= cuts[s] * cell - 1e-12).all()
        assert (x[s][m[s]] <= cuts[s + 1] * cell + 1e-12).all()


def _cloud(seed):
    rng = np.random.default_rng(seed)
    n = 2048
    return _state(rng.random((n, 3)), rng.normal(scale=0.1, size=(n, 3)),
                  np.full(n, 1.5 / n), 0.5 + rng.random(n),
                  np.full(n, 0.07), periodic=False)


def test_wslab_gravity_matches_single_device():
    """Ring gravity (direct sum, the blocks hopping the ring) on an open
    box equals the single-device engine's direct gravity (kernel G's plain
    version) over 2 steps at 1e-8."""
    cfg = tconf.SPHConfig(dim=3, adaptive_h=False, grad_h=False,
                          gravity=True, G=1.3, grav_eps=0.05)
    st, dom = _cloud(11)
    st0, ref, ref_dts = _single(st, cfg, dom, 2)
    recs, _ = _dist(st0, cfg, dom, 4, [("step",)] * 2)
    np.testing.assert_allclose([r["dts"][0] for r in recs], ref_dts,
                               rtol=1e-10)
    _compare(_real(recs[-1]), ref, dom, ("vel", "rho", "acc", "u"), 1e-8)


def test_wslab_p3m_gravity_matches_single_device():
    """Distributed P3M (every rank's deposit on a full mesh, one SUM
    all-reduce, the screened short range over each rank's candidates)
    equals the single-device P3M over 2 steps, at the JAX test's 1e-3 (the
    JAX package's own ``sorted_mesh=False`` case)."""
    cfg = tconf.SPHConfig(dim=3, adaptive_h=False, grad_h=False,
                          gravity=True, G=1.3, grav_eps=0.004,
                          grav_solver="p3m", grav_mesh=64,
                          grav_rs_cells=2.0)
    st, dom = _cloud(13)
    st0, ref, _ = _single(st, cfg, dom, 2)
    recs, _ = _dist(st0, cfg, dom, 4, [("step",)] * 2)
    _compare(_real(recs[-1]), ref, dom, ("vel", "rho", "acc"), 1e-3)


def test_wslab_adaptive_matches_fixed():
    """Drift-gated rebuilds change when the bundle of routes, exchange and
    build runs, never the pairs: an adaptive 4-step chunk (at most 4 steps
    of staleness) equals the every-step rebuild at 1e-12 on the dts and
    1e-9 on the state, with fewer builds (2 ranks, a Sedov blast)."""
    cfg = dataclasses.replace(tconf.SEDOV, newton_iters=2, balsara=True)
    ic = sedov.build(n_side=12, E=1.0)
    st, dom = _state(ic["pos"], ic["vel"], ic["mass"], ic["u"], ic["h"],
                     hi=ic["box"])
    spec1 = win.plan_measured(st.pos, dom, h_max=float(st.h.max()) * 1.1,
                              dim=3, cutoff_scale=1.05)
    st0 = wengine.update_derived(st, cfg, dom, spec1)
    recs, _ = _dist(st0, cfg, dom, 2, [("chunk", 4, 1, 0), ("reset",),
                                       ("chunk", 4, 1, 4)],
                    cutoff_scale=1.05)
    fixed, adaptive = recs[0], recs[2]
    assert fixed["builds"] == 4 and 1 <= adaptive["builds"] < 4
    np.testing.assert_allclose(adaptive["dts"], fixed["dts"], rtol=1e-12)
    a, b = _real(adaptive), _real(fixed)
    for f in ("pos", "vel", "rho", "u", "h", "P", "acc", "du_dt"):
        scale = np.abs(b[f]).max() + 1e-30
        np.testing.assert_allclose(a[f], b[f], rtol=1e-9, atol=1e-9 * scale,
                                   err_msg=f)


def _shard_calls(c):
    """A rank's shard structure (2 slabs of the 12^3 lattice, the card's
    window knobs) and the kernel calls of one derived pass on it, held to
    what the CUDA kernels take and rely on."""
    from tests._slab_helpers import kernel_calls
    from tests.test_torch_cull import _missed

    cfg = dataclasses.replace(tconf.TURB, newton_iters=2)
    st, dom = _lattice(n_side=12)
    spec1 = win.plan_measured(st.pos, dom, h_max=float(st.h.max()) * 1.1,
                              dim=3)
    st0 = wengine.update_derived(st, cfg, dom, spec1)
    spec = tslab.plan(dom, st0.n, float(st0.h.max()) * 1.1, c.world,
                      fast_sub=3, rgroups=2)
    cuts = tslab.equal_cuts(spec.ncell_ax, c.world)
    sh = tslab.distribute(st0, dom, spec, cuts, c.rank)
    spec = tslab.refine_wseg(spec, tslab.max_run(c, sh, cuts, dom, spec)[0])
    calls, own = kernel_calls(c, sh, cuts, dom, cfg, spec)
    (a, ka), (cc, kc) = calls["A"], calls["C"]
    wd, wspec = a[0], a[1]
    # the tables and fields the CUDA entry points check
    wk._check_cuda(wd, wspec, cfg, a[2], dict(
        pos_s=a[2], mass_s=a[3], h0_s=a[4], vel_s=ka["vel_s"]))
    wk._check_cuda(wd, wspec, cfg, cc[2], dict(zip(
        ("pos_s", "vel_s", "mass_s", "h_s", "rho_s", "P_s", "cs_s", "om_s",
         "bf_s"), cc[2:11])))
    # a group's non-empty ranges start in rising order
    lo, full = wd.w_lo.long(), wd.w_nact > 0
    before = torch.cummax(torch.where(full, lo, -1), 1).values
    before = torch.cat([torch.full_like(lo[:, :1], -1), before[:, :-1]], 1)
    assert bool((lo >= before)[full].all())
    # the warp cull keeps every live pair of A (at h0) and C
    missed = {}
    for kind, f in (("A", dict(pos_s=a[2], mass_s=a[3], h_s=a[4])),
                    ("C", dict(pos_s=cc[2], mass_s=cc[4], h_s=cc[5]))):
        m, live, _, _ = _missed(wspec, wd, f, kind)
        assert live > 0 and m == 0, (kind, m, live)
        missed[kind] = live
    # the rows the pass keeps are this rank's real particles, and only the
    # groups that hold some define windows
    assert int(own.sum()) == int((sh.mass > 0).sum())
    act = wk._group_active(wd, wspec).repeat_interleave(wspec.group)
    assert bool(act[own].all()) and 0 < int(act.sum()) < act.numel()
    return dict(live_pairs=missed, own=int(own.sum()))


def test_shard_structure_takes_the_cuda_entry_points():
    """On each rank of 2, the masked structure and the fields a derived
    pass hands kernels A and C pass the CUDA wrappers' checks, their
    in-place ranges rise with the segment (which the kernels' dedup
    relies on), and the warp cull drops no live pair: what the card runs
    on a shard, held on the CPU."""
    got = comm.launch(_shard_calls, 2, "cpu", "gloo", timeout=60,
                      deadline=300)
    assert got["own"] > 0 and min(got["live_pairs"].values()) > 0


_CULL = wk._LivePairs.keep


class _NoCull(wk._LivePairs):
    """The plain versions' pair list without its box cull (every candidate
    with mass is kept), counting the candidates the cull drops."""

    dropped = 0

    @staticmethod
    def keep(pos_i, m_i, pos_j, m_j, reach_i, reach_j):
        culled = _CULL(pos_i, m_i, pos_j, m_j, reach_i, reach_j)
        _NoCull.dropped += int(((m_j > 0) & ~culled).sum())
        return m_j > 0


def _bitwise_without_cull(run):
    """``run()`` with the plain pair list's cull and without it: every
    output tensor equal bit for bit. Returns the candidates the cull
    dropped."""
    with_cull = run()
    saved, _NoCull.dropped = wk._LivePairs, 0
    wk._LivePairs = _NoCull
    try:
        without = run()
    finally:
        wk._LivePairs = saved
    for x, y in zip(with_cull, without):
        assert torch.equal(x, y)
    return _NoCull.dropped


def _shard_cull(c):
    """Kernels A's and C's plain versions on a rank's masked shard
    structure (2 slabs of the 12^3 lattice, the card's window knobs), with
    and without the box cull."""
    from tests._slab_helpers import kernel_calls

    cfg = dataclasses.replace(tconf.TURB, newton_iters=2)
    st, dom = _lattice(n_side=12)
    spec1 = win.plan_measured(st.pos, dom, h_max=float(st.h.max()) * 1.1,
                              dim=3)
    st0 = wengine.update_derived(st, cfg, dom, spec1)
    spec = tslab.plan(dom, st0.n, float(st0.h.max()) * 1.1, c.world,
                      fast_sub=3, rgroups=2)
    cuts = tslab.equal_cuts(spec.ncell_ax, c.world)
    sh = tslab.distribute(st0, dom, spec, cuts, c.rank)
    spec = tslab.refine_wseg(spec, tslab.max_run(c, sh, cuts, dom, spec)[0])
    calls, _ = kernel_calls(c, sh, cuts, dom, cfg, spec)
    dropped = {}
    for which, plain in (("A", wk.solve_h_density_plain),
                         ("C", wk.forces_plain)):
        a, k = calls[which]
        dropped[which] = _bitwise_without_cull(lambda: plain(*a, **k))
    return dropped


def test_plain_cull_is_bitwise_on_a_shard():
    """The box cull of the plain versions' pair list (``_LivePairs.keep``)
    drops candidates on a shard's masked structure (padding and slab ghosts
    inactive) and changes no bit of kernels A's and C's plain outputs."""
    got = comm.launch(_shard_cull, 2, "cpu", "gloo", timeout=60,
                      deadline=300)
    assert min(got.values()) > 0, got


def test_plain_cull_is_bitwise_unmasked():
    """The same on an unmasked single-device structure: the window
    engine's whole derived pass, with and without the cull, on the
    jittered 12^3 lattice."""
    cfg = dataclasses.replace(tconf.TURB, newton_iters=2)
    st, dom = _lattice(n_side=12)
    spec = win.plan_measured(st.pos, dom, h_max=float(st.h.max()) * 1.1,
                             dim=3, fast_sub=3, rgroups=2)
    dropped = _bitwise_without_cull(
        lambda: wengine.update_derived(st, cfg, dom, spec))
    assert dropped > 0
