"""The port's sorted-order P3M mesh (``sphax_torch.physics.pm_sorted``)
against ``sphax.physics.pm_sorted``, float64.

The plan equals the JAX plan; on the same sorted rows (the JAX window
structure's, carried across as arrays) the deposit and the interpolation
equal the JAX version's at 1e-12, on the scatter mesh at 1e-12 too
(tests/unit/test_pm_sorted.py's bounds) and with the dropped count;
``pm.mesh_accel_sorted`` equals ``pm.mesh_accel`` at 1e-10; a brick too
small for its program sends most rows through the fallback and stays
exact, and a small capacity counts its drops as the JAX version does;
``wengine.mesh_fallback_count`` equals the JAX counter, and the CLI logs
it as ``mesh_fb`` outside its rate. The port's engines run the scatter
mesh where the JAX package runs this one on an accelerator: 2 gloo ranks
of ``dist.wslab`` (a step and a 2-step chunk) against ``sphax.dist.wslab``
with ``sorted_mesh=True`` on 2 fake devices at 1e-10, and one 2-rank
pencil step the same way (a 1x2 grid).
"""
import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sphax
from sphax import SPHConfig
from sphax import problems as jprob
from sphax.dist import pencil as jpencil
from sphax.dist import wslab as jslab
from sphax.neighbors import window as jwin
from sphax.physics import dense as jdense
from sphax.physics import pm as jpm
from sphax.physics import pm_sorted as jps
from sphax.physics import wengine as jeng
from sphax_torch import configs as tconf
from sphax_torch import convert, problems
from sphax_torch.__main__ import main as cli
from sphax_torch.core.state import make_state
from sphax_torch.dist import comm
from sphax_torch.io import metrics
from sphax_torch.neighbors import window as twin
from sphax_torch.physics import pm, pm_sorted, wengine
from tests._slab_helpers import lockstep, pencil_lockstep
from tests.dist.test_wslab import _problem
from tests.unit.test_pm_sorted import _state

torch.set_num_threads(1)

M = 32
P3M = SPHConfig(dim=3, adaptive_h=False, grad_h=False, gravity=True, G=1.3,
                grav_eps=0.004, grav_solver="p3m", grav_mesh=M,
                grav_rs_cells=2.0)


def _close(got, want, rtol, what="", atol=None):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, what
    scale = np.abs(want).max() + 1e-300
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * scale if atol is None else atol,
                               err_msg=what)


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _both(periodic, seed):
    """The JAX test's state (half uniform, half a tight blob) and its
    window structure, with the port's side of it: (jax tuple, torch
    domain, sorted positions, is_real, sorted masses, plan, jax plan)."""
    pos, mass, h, dom, spec, wd = _state(periodic, seed=seed)
    jplan = jps.plan_mesh(spec, M)
    tdom = convert.domain_from_numpy(np.asarray(dom.lo), np.asarray(dom.hi),
                                     dom.periodic, "cpu", torch.float64)
    tplan = convert.mesh_plan_from_fields(**dataclasses.asdict(jplan))
    mass_s = jwin.gather_sorted(mass, wd)
    return ((pos, mass, dom, spec, wd), tdom, _t(wd.pos_s),
            torch.as_tensor(np.array(wd.is_real)), _t(mass_s), tplan,
            jplan)


@pytest.mark.parametrize("node_per_cell", [None, (2.5, 0.75)])
@pytest.mark.parametrize("h_max", [0.05, 0.09])
def test_plan_mesh_matches(h_max, node_per_cell):
    """The same G, bricks and capacity, from the port's own window spec
    and from the JAX one; both refuse 2D."""
    pos, _, _, dom, _, _ = _state(True)
    jspec = jwin.plan_measured(pos, dom, h_max=h_max, dim=3)
    tdom = convert.domain_from_numpy(np.asarray(dom.lo), np.asarray(dom.hi),
                                     dom.periodic, "cpu", torch.float64)
    tspec = twin.plan_measured(_t(pos), tdom, h_max=h_max, dim=3)
    assert tspec == convert.spec_from_fields(**dataclasses.asdict(jspec))
    for m in (16, M, 128):
        want = jps.plan_mesh(jspec, m, node_per_cell=node_per_cell)
        got = pm_sorted.plan_mesh(tspec, m, node_per_cell=node_per_cell)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got == convert.mesh_plan_from_fields(
            **dataclasses.asdict(want))
    spec2 = dataclasses.replace(tspec, res=tspec.res[:2])
    with pytest.raises(ValueError):
        pm_sorted.plan_mesh(spec2, M)


@pytest.mark.parametrize("periodic", [True, False])
def test_deposit_and_interp_match_jax(periodic):
    """deposit_sorted and interp_sorted against the JAX functions and
    against the scatter mesh (pm._deposit, pm._interp) at 1e-12."""
    (pos, mass, dom, spec, wd), tdom, pos_s, real, mass_s, tplan, jplan = \
        _both(periodic, seed=0)
    w = torch.where(real, mass_s, 0.0)
    got, dropped = pm_sorted.deposit_sorted(pos_s, w, tdom, M, periodic,
                                            tplan)
    want, jdrop = jps.deposit_sorted(wd.pos_s, jnp.asarray(w.numpy()), dom,
                                     M, periodic, jplan)
    assert int(dropped) == int(jdrop) == 0
    tot = float(mass.sum())
    _close(got, want, 1e-12, "deposit vs jax", atol=1e-12 * tot)
    lo, cell = tdom.lo, tdom.extent / M
    ref = pm._deposit(tdom.wrap(_t(pos)), _t(mass), lo, cell, M, periodic)
    _close(got, ref, 1e-12, "deposit vs scatter", atol=1e-12 * tot)
    np.testing.assert_allclose(float(got.sum()), tot, rtol=1e-12)

    grids = np.random.default_rng(7).standard_normal((3, M, M, M))
    got_s, dropped = pm_sorted.interp_sorted(_t(grids), pos_s, real, tdom,
                                             M, periodic, tplan)
    want_s, jdrop = jps.interp_sorted(jnp.asarray(grids), wd.pos_s,
                                      wd.is_real, dom, M, periodic, jplan)
    assert int(dropped) == int(jdrop) == 0
    _close(got_s[real], np.asarray(want_s)[np.asarray(wd.is_real)], 1e-12,
           "interp vs jax", atol=1e-12)
    ref = pm._interp(list(_t(grids)), tdom.wrap(_t(pos)), lo, cell, M,
                     periodic)
    _close(got_s[torch.as_tensor(np.array(wd.inv)).long()], ref, 1e-12,
           "interp vs scatter", atol=1e-12)


@pytest.mark.parametrize("periodic", [True, False])
def test_mesh_accel_sorted_matches(periodic):
    """pm.mesh_accel_sorted against pm.mesh_accel at 1e-10 and against
    the JAX mesh_accel_sorted at 1e-12."""
    (pos, mass, dom, spec, wd), tdom, pos_s, real, mass_s, tplan, jplan = \
        _both(periodic, seed=2)
    cfg = tconf.SPHConfig(**dataclasses.asdict(P3M))
    got_s, dropped = pm.mesh_accel_sorted(pos_s, mass_s, real, cfg, tdom,
                                          tplan)
    inv = torch.as_tensor(np.array(wd.inv)).long()
    want = pm.mesh_accel(_t(pos), _t(mass), cfg, tdom)
    assert int(dropped) == 0
    _close(got_s[inv], want, 1e-10, "sorted vs scatter")
    jgot, jdrop = jpm.mesh_accel_sorted(wd.pos_s, jnp.asarray(mass_s.numpy()),
                                        wd.is_real, P3M, dom, jplan)
    assert int(jdrop) == 0
    _close(got_s[inv], np.asarray(jgot)[np.asarray(wd.inv)], 1e-12,
           "sorted vs jax")


def test_tiny_bricks_fall_back_exactly_and_drops_are_counted():
    """Bricks of 3 x 3 nodes send most rows through the fallback and the
    deposit stays exact; at a capacity of 128 rows the drops equal the JAX
    count, and fallback_stats counts the same rows."""
    (pos, mass, dom, spec, wd), tdom, pos_s, real, mass_s, tplan, jplan = \
        _both(True, seed=3)
    w = torch.where(real, mass_s, 0.0)
    tiny = dataclasses.replace(tplan, Bx=3, By=3)
    got, dropped = pm_sorted.deposit_sorted(pos_s, w, tdom, M, True, tiny)
    ref = pm._deposit(tdom.wrap(_t(pos)), _t(mass), tdom.lo,
                      tdom.extent / M, M, True)
    assert int(dropped) == 0
    _close(got, ref, 1e-12, "tiny bricks", atol=1e-12 * float(mass.sum()))
    n_fb, n_drop = pm_sorted.fallback_stats(pos_s, w > 0, tdom, M, True, tiny)
    assert int(n_fb) > pos.shape[0] // 2 and int(n_drop) == 0

    small = dataclasses.replace(tiny, cap=128)
    _, dropped = pm_sorted.deposit_sorted(pos_s, w, tdom, M, True, small)
    jsmall = dataclasses.replace(jplan, Bx=3, By=3, cap=128)
    _, jdrop = jps.deposit_sorted(wd.pos_s, jnp.asarray(w.numpy()), dom, M,
                                  True, jsmall)
    assert int(dropped) == int(jdrop) > 0
    stats = pm_sorted.fallback_stats(pos_s, w > 0, tdom, M, True, small)
    jstats = jps.fallback_stats(wd.pos_s, jnp.asarray((w > 0).numpy()), dom,
                                M, True, jsmall)
    assert [int(x) for x in stats] == [int(x) for x in jstats]
    assert int(stats[1]) == int(dropped)


@pytest.mark.parametrize("periodic", [True, False])
def test_mesh_fallback_count_matches(periodic):
    """wengine.mesh_fallback_count equals the JAX counter, and the
    sorted mesh over the same window structure equals the scatter mesh the
    window engine runs at 1e-10."""
    pos, mass, h, dom, spec, _ = _state(periodic, n=2000, seed=5)
    jst = sphax.make_state(pos, jnp.zeros_like(pos), mass,
                           jnp.ones_like(mass), h)
    want = jeng.mesh_fallback_count(jst, P3M, dom, spec)
    tdom = convert.domain_from_numpy(np.asarray(dom.lo), np.asarray(dom.hi),
                                     dom.periodic, "cpu", torch.float64)
    tspec = convert.spec_from_fields(**dataclasses.asdict(spec))
    tst = make_state(_t(pos), torch.zeros(pos.shape, dtype=torch.float64),
                     _t(mass), torch.ones(pos.shape[0], dtype=torch.float64),
                     _t(h))
    cfg = tconf.SPHConfig(**dataclasses.asdict(P3M))
    got = wengine.mesh_fallback_count(tst, cfg, tdom, tspec)
    assert [int(x) for x in got] == [int(x) for x in want]
    assert int(got[1]) == 0
    wd = twin.build(tst.pos, tdom, tspec)
    acc_s, drop = pm.mesh_accel_sorted(
        wd.pos_s, twin.gather_sorted(tst.mass, wd), wd.is_real, cfg, tdom,
        pm_sorted.plan_mesh(tspec, M))
    assert int(drop) == 0
    _close(acc_s[wd.inv], pm.mesh_accel(tst.pos, tst.mass, cfg, tdom),
           1e-10, "sorted vs scatter")


def test_cli_logs_mesh_fb(tmp_path):
    """A P3M run of the CLI logs mesh_fb in its chunk record: the port's
    counter on the state it logs, which equals the JAX counter (both on
    that state in fp64, with the problem's own structure)."""
    out = str(tmp_path / "p3m")
    st, _, step = cli(["turb", "n=12", "gravity=1", "grav_solver=p3m",
                       "grav_mesh=32", "device=cpu", "max_steps=2",
                       "chunk=2", f"out={out}"])
    with open(os.path.join(out, "metrics.jsonl")) as f:
        rec = json.loads(f.readline())
    assert rec["step"] == step == 2
    grav = dict(gravity=True, grav_solver="p3m", grav_mesh=32)
    tp = problems.turb(n=12, device="cpu")
    cfg = dataclasses.replace(tp.cfg, **grav)
    n_fb, n_drop = wengine.mesh_fallback_count(st, cfg, tp.domain, tp.wspec)
    assert rec["mesh_fb"] == int(n_fb) and int(n_drop) == 0

    st64 = st._replace(**{k: getattr(st, k).double() for k in st._fields
                          if getattr(st, k).is_floating_point()})
    tp64 = problems.turb(n=12, dtype=torch.float64, device="cpu")
    jp = jprob.REGISTRY["turb"](dtype=jnp.float64, n=12)
    want = jeng.mesh_fallback_count(
        sphax.ParticleState(**{k: jnp.asarray(getattr(st64, k).numpy())
                               for k in st64._fields}),
        dataclasses.replace(jp.cfg, **grav), jp.domain, jp.wspec)
    got = wengine.mesh_fallback_count(st64, dataclasses.replace(
        tp64.cfg, **grav), tp64.domain, tp64.wspec)
    assert [int(x) for x in got] == [int(x) for x in want]


def test_untimed_work_leaves_the_rate(monkeypatch):
    """Wall time spent inside MetricsLogger.untimed (where the CLI counts
    mesh_fb) is not in the next record's particle-steps rate."""
    clock = iter([0.0, 2.0, 5.0, 6.0])
    monkeypatch.setattr(metrics.time, "time", lambda: next(clock))
    log = metrics.MetricsLogger()
    with log.untimed():
        pass
    rec = log.log_record({}, 10, 100)
    assert rec["particle_steps_per_sec"] == pytest.approx(100 * 10 / 3.0)


def _jax_slab_ops(sh, mesh, cfg, spec, cuts, dom):
    """A step, then two more: the JAX package's make_chunk with
    sorted_mesh does not trace under x64 (its scan carries the mesh drop
    count as int32 and gets int64 back), so its 2-step chunk at
    rebuild_every=1 is taken as two make_step calls, the same steps."""
    step = jslab.make_step(mesh, cfg, spec, use_pallas=False,
                           sorted_mesh=True)
    recs = []
    for n in (1, 2):
        dts, hs = [], []
        for _ in range(n):
            sh, dt, health = step(sh, jnp.asarray(cuts), dom)
            dts.append(float(dt))
            hs.append(np.asarray(health))
        recs.append(dict(dts=np.array(dts), health=np.max(hs, axis=0)))
    recs[-1]["rows"] = {k: np.asarray(getattr(sh, k)) for k in sh._fields}
    return recs


def _check(got, want, what):
    for g, w in zip(got, want):
        assert not np.any(w["health"]) and not np.any(g["health"]), what
        _close(g["dts"], w["dts"], 1e-10, f"{what}: dts")
    g, w = got[-1]["rows"], want[-1]["rows"]
    real = w["mass"] > 0
    np.testing.assert_array_equal(g["mass"] > 0, real)
    for k, v in w.items():
        _close(g[k][real], v[real], 1e-10, f"{what}: {k}")
    acc = w["acc"][real]
    assert np.isfinite(acc).all() and np.abs(acc).max() > 0


def test_wslab_matches_the_sorted_mesh_reference():
    """A wslab P3M step and a 2-step chunk (rebuild_every=1, the scatter
    mesh) on 2 gloo ranks against sphax.dist.wslab with the sorted mesh
    (use_pallas=False, sorted_mesh=True) on 2 fake devices: dts, health
    and every field of the real rows at 1e-10."""
    st, dom = _problem(P3M)
    st = jdense.update_derived(st, P3M, dom, block=64)
    mesh = jslab.make_mesh(2)
    spec = jslab.plan(dom, st.n, h_max=float(st.h.max()) * 1.1, n_shards=2)
    cuts = jslab.equal_cuts(spec.ncell_ax, 2)
    sh = jslab.distribute(st, dom, mesh, spec, cuts)
    mr, _ = jslab.make_max_run(mesh, spec)(sh, jnp.asarray(cuts), dom)
    spec = jslab.refine_wseg(spec, int(mr))
    rows0 = {k: np.asarray(getattr(sh, k)) for k in sh._fields}
    want = _jax_slab_ops(sh, mesh, P3M, spec, cuts, dom)
    tspec = convert.wslab_spec_from_fields(**dataclasses.asdict(spec))
    cfg = tconf.SPHConfig(**dataclasses.asdict(P3M))
    got = comm.launch(
        lockstep, 2, "cpu", "gloo", timeout=60, deadline=240,
        args=(rows0, (np.asarray(dom.lo), np.asarray(dom.hi), dom.periodic),
              cfg, tspec, cuts, [("step",), ("chunk", 2, 1, 0)]))
    _check(got, want, "wslab against the sorted mesh")


def test_pencil_matches_the_sorted_mesh_reference():
    """One pencil P3M step (the scatter mesh) on a 1x2 grid of gloo ranks
    against sphax.dist.pencil with the sorted mesh (use_pallas=False,
    sorted_mesh=True) at 1e-10."""
    st, dom = _problem(P3M)
    st = jdense.update_derived(st, P3M, dom, block=64)
    mesh = jpencil.make_mesh(1, 2)
    spec = jpencil.plan(dom, st.n, h_max=float(st.h.max()) * 1.1, ns0=1,
                        ns1=2)
    c0 = jpencil.equal_cuts(spec.ncell0, 1)
    c1 = jpencil.equal_cuts(spec.ncell1, 2)
    sh = jpencil.distribute(st, dom, mesh, spec, c0, c1)
    mr, _ = jpencil.make_max_run(mesh, spec)(sh, jnp.asarray(c0),
                                             jnp.asarray(c1), dom)
    spec = jpencil.refine_wseg(spec, int(mr))
    rows0 = {k: np.asarray(getattr(sh, k)) for k in sh._fields}
    step = jpencil.make_step(mesh, P3M, spec, use_pallas=False,
                             sorted_mesh=True)
    sh, dt, health = step(sh, jnp.asarray(c0), jnp.asarray(c1), dom)
    want = [dict(dts=np.atleast_1d(np.asarray(dt)),
                 health=np.asarray(health),
                 rows={k: np.asarray(getattr(sh, k)) for k in sh._fields})]
    tspec = convert.pencil_spec_from_fields(**dataclasses.asdict(spec))
    cfg = tconf.SPHConfig(**dataclasses.asdict(P3M))
    got = comm.launch(
        pencil_lockstep, 2, "cpu", "gloo", timeout=60, deadline=240,
        args=(rows0, (np.asarray(dom.lo), np.asarray(dom.hi), dom.periodic),
              cfg, tspec, (c0, c1), [("step",)]))
    _check(got, want, "pencil against the sorted mesh")
