"""The port's equal-extent slab decomposition (``sphax_torch.dist.slab``)
against ``sphax.dist.slab``.

``plan`` gives the JAX spec and raises where it raises; ``distribute``
gives the JAX sharded layout, rank by rank. Then 2 gloo ranks run a step,
a 2-step chunk, a redistribution and a step from the JAX layout, beside
the same ops of ``sphax.dist.slab`` on 2 of the conftest's fake devices:
the dts at 1e-10 and every field of the real rows at 1e-8
(tests/dist/test_slab.py's bounds) after each op, which rows are real
(padding rows are don't-care: the port's passes walk the trash band only
as deep as the fullest real cell), and ``gather_real``'s rows; and
after the first three steps the real rows against the port's dense engine
on one device (the single-device run of tests/dist/test_slab.py).
"""
import dataclasses

import numpy as np
import pytest
import torch

from sphax.dist import slab as jslab
from sphax.physics import dense as jdense
from sphax_torch import configs as tconf
from sphax_torch import convert
from sphax_torch.dist import comm
from sphax_torch.dist import slab as tslab
from sphax_torch.integrate import leapfrog
from sphax_torch.physics import dense
from tests._slab_helpers import eq_slab_lockstep
from tests.dist.test_slab import DIST_CONFIGS, _problem

torch.set_num_threads(1)

def _tdom(jdom):
    return convert.domain_from_numpy(np.asarray(jdom.lo), np.asarray(jdom.hi),
                                     jdom.periodic, "cpu", torch.float64)


def _tstate(jst):
    return convert.state_from_numpy({k: np.asarray(getattr(jst, k))
                                     for k in jst._fields}, "cpu",
                                    torch.float64)


def _close(got, want, rtol, what):
    scale = np.abs(want).max() + 1e-300
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale,
                               err_msg=what)


@pytest.mark.parametrize("ns,kw", [
    (2, {}), (4, dict(margin_factor=1.2)),
    (3, dict(slab_axis=1, pad_factor=2.0, ghost_factor=3.0)),
    (2, dict(occupancy_safety=5.0, slab_axis=2))])
def test_plan_matches_reference(ns, kw):
    """The same DistSpec (its grid included); both raise on a slab
    thinner than the margin."""
    jst, jdom = _problem(DIST_CONFIGS["fixed_h"], n_side=16)
    tdom = _tdom(jdom)
    h_max = float(jst.h.max()) * 1.1
    jspec = jslab.plan(jdom, jst.n, h_max=h_max, n_shards=ns, **kw)
    tspec = tslab.plan(tdom, jst.n, h_max=h_max, n_shards=ns, **kw)
    assert tspec == convert.dist_spec_from_fields(**dataclasses.asdict(jspec))
    with pytest.raises(ValueError):
        jslab.plan(jdom, jst.n, h_max=0.3, n_shards=8)
    with pytest.raises(ValueError):
        tslab.plan(tdom, jst.n, h_max=0.3, n_shards=8)


@pytest.mark.parametrize("ns", [2, 3])
def test_distribute_matches_reference(ns):
    """Rank by rank, the rows of the JAX sharded layout: each slab's
    particles in row order, then the padding rows in its trash band."""
    jst, jdom = _problem(DIST_CONFIGS["fixed_h"], n_side=12)
    jst = jdense.update_derived(jst, DIST_CONFIGS["fixed_h"], jdom, block=64)
    jspec = jslab.plan(jdom, jst.n, h_max=float(jst.h.max()) * 1.1,
                       n_shards=ns, margin_factor=1.2)
    jsh = jslab.distribute(jst, jdom, jslab.make_mesh(ns), jspec)
    tspec = convert.dist_spec_from_fields(**dataclasses.asdict(jspec))
    got = [tslab.distribute(_tstate(jst), _tdom(jdom), tspec, r)
           for r in range(ns)]
    for k in jst._fields:
        np.testing.assert_array_equal(
            np.concatenate([getattr(g, k).numpy() for g in got]),
            np.asarray(getattr(jsh, k)), k)


OPS = [("step",), ("chunk", 2), ("redistribute",), ("step",)]

# tests/dist/test_slab.py's configurations; grad-h and Balsara with two
# Newton updates a pass (twelve there), which keeps the CPU ranks' cell
# passes to a few seconds a step
CONFIGS = {
    "fixed_h": DIST_CONFIGS["fixed_h"],
    "gradh_balsara": dataclasses.replace(DIST_CONFIGS["gradh_balsara"],
                                         newton_iters=2),
}


def _jax_ops(sh, mesh, cfg, spec, dom):
    step = jslab.make_step(mesh, cfg, spec)
    recs = []
    for op in OPS:
        rec = {"op": op}
        if op[0] == "step":
            sh, dt = step(sh, dom)
            rec["dts"] = np.atleast_1d(np.asarray(dt))
        elif op[0] == "chunk":
            sh, dts = jslab.make_chunk(mesh, cfg, spec, op[1])(sh, dom)
            rec["dts"] = np.asarray(dts)
        else:
            sh = jslab.redistribute(sh, dom, mesh, spec)
        rec["rows"] = {k: np.asarray(getattr(sh, k)) for k in sh._fields}
        recs.append(rec)
    recs[-1]["real"] = {k: np.asarray(v) for k, v in
                        jslab.gather_real(sh)._asdict().items()}
    return recs


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_ranks_match_reference(name):
    cfg = CONFIGS[name]
    jst, jdom = _problem(cfg, n_side=10)
    jst = jdense.update_derived(jst, cfg, jdom, block=64)
    mesh = jslab.make_mesh(2)
    jspec = jslab.plan(jdom, jst.n, h_max=float(jst.h.max()) * 1.1,
                       n_shards=2)
    jsh = jslab.distribute(jst, jdom, mesh, jspec)
    rows0 = {k: np.asarray(getattr(jsh, k)) for k in jsh._fields}
    want = _jax_ops(jsh, mesh, cfg, jspec, jdom)

    tcfg = tconf.SPHConfig(**dataclasses.asdict(cfg))
    tspec = convert.dist_spec_from_fields(**dataclasses.asdict(jspec))
    got = comm.launch(
        eq_slab_lockstep, 2, "cpu", "gloo", timeout=60, deadline=240,
        args=(rows0, (np.asarray(jdom.lo), np.asarray(jdom.hi),
                      jdom.periodic), tcfg, tspec, OPS))

    for g, w in zip(got, want):
        what = f"{name}, after {g['op']}"
        if "dts" in w:
            _close(g["dts"], w["dts"], 1e-10, f"{what}: dts")
            assert not np.any(g["health"]), (what, g["health"])
        real = w["rows"]["mass"] > 0
        np.testing.assert_array_equal(g["rows"]["mass"] > 0, real)
        for k, v in w["rows"].items():
            _close(g["rows"][k][real], v[real], 1e-8, f"{what}: {k}")
    for k, v in want[-1]["real"].items():
        _close(got[-1]["real"][k], v, 1e-8, f"{name}: gather_real {k}")

    # the first three steps against the port's dense engine on one device
    st, dom = _tstate(jst), _tdom(jdom)

    def engine(s):
        return dense.update_derived(s, tcfg, dom, block=64)
    dts = []
    for _ in range(3):
        st, dt = leapfrog.step(st, tcfg, dom, engine, wrap=False)
        dts.append(float(dt))
    _close(np.concatenate([got[0]["dts"], got[1]["dts"]]), np.array(dts),
           1e-10, f"{name}: dts against one device")
    rows = got[1]["rows"]
    real = rows["mass"] > 0

    def order(p):
        return np.lexsort((p[:, 2], p[:, 1], p[:, 0]))
    oi, oj = order(rows["pos"][real]), order(st.pos.numpy())
    for k in ("pos", "vel", "u", "h", "rho", "P", "acc", "du_dt"):
        _close(rows[k][real][oi], getattr(st, k).numpy()[oj], 1e-8,
               f"{name}: {k} against one device")


def test_gravity_and_mm_visc_refused():
    """step and chunk refuse what the JAX make_step refuses."""
    jst, jdom = _problem(DIST_CONFIGS["fixed_h"], n_side=12)
    tspec = tslab.plan(_tdom(jdom), jst.n, h_max=0.1, n_shards=2)
    for cfg in (tconf.SPHConfig(dim=3, gravity=True),
                tconf.SPHConfig(dim=3, mm_visc=True)):
        with pytest.raises(NotImplementedError):
            tslab.step(None, _tstate(jst), _tdom(jdom), cfg, tspec)
        with pytest.raises(NotImplementedError):
            tslab.chunk(None, _tstate(jst), _tdom(jdom), cfg, tspec, 2)


def test_fp32_ranks_stay_finite():
    """In fp32 a zero-mass padding row's Newton step is 0 / -0 (-1e-300
    underflows): the ranks keep such rows' h, so 3 steps of 2 ranks in
    fp32 stay finite on every row, with health 0."""
    cfg = CONFIGS["gradh_balsara"]
    jst, jdom = _problem(cfg, n_side=10)
    jst = jdense.update_derived(jst, cfg, jdom, block=64)
    tspec = tslab.plan(_tdom(jdom), jst.n, h_max=float(jst.h.max()) * 1.1,
                       n_shards=2)
    rows = [convert.state_to_numpy(tslab.distribute(_tstate(jst),
                                                    _tdom(jdom), tspec, r))
            for r in range(2)]
    rows = {k: np.concatenate([r[k] for r in rows]) for k in rows[0]}
    got = comm.launch(
        eq_slab_lockstep, 2, "cpu", "gloo", timeout=60, deadline=240,
        args=(rows, (np.asarray(jdom.lo), np.asarray(jdom.hi),
                     jdom.periodic), tconf.SPHConfig(**dataclasses.asdict(
                         cfg)), tspec, [("step",), ("chunk", 2)],
              torch.float32))
    for r in got:
        assert not np.any(r["health"]), r["health"]
        for k, v in r["rows"].items():
            assert np.isfinite(v).all(), (r["op"], k)
    assert got[-1]["real"]["pos"].shape[0] == jst.n
