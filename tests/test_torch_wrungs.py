"""Block timesteps over the slab decomposition (``sphax_torch.dist.wrungs``
and the work weights of ``sphax_torch.dist.wslab``) against
``sphax.dist.wrungs`` and ``sphax.dist.wslab``.

The port's ranks (gloo, CPU tensors) run ``tests/_slab_helpers.lockstep``'s
ops; the JAX package runs the same ops with ``use_pallas=False`` on the
conftest's fake devices, from the same sharded arrays. After every op:
every field of the sharded state at 1e-10, the dts at 1e-10, the closings
per tick, the dt violations, the health counters and the builds equal, and
so are the work histogram, the ranks' work and the cuts a work rebalance
gives. The Sedov blast at 16^3 (``tests/dist/test_rungs_dist.py``'s set-up)
spreads the rungs; off centre on 4 ranks, some rank has no closer on some
ticks, and its kernels run on a fully masked structure.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sphax
from sphax.dist import wrungs as jrungs
from sphax.dist import wslab as jslab
from sphax.ics import sedov as jsedov
from sphax.neighbors import window as jwin
from sphax.physics import wengine as jeng
from sphax_torch import configs as tconf
from sphax_torch import convert
from sphax_torch.dist import comm
from sphax_torch.dist import wslab as tslab
from sphax_torch.integrate.rungs import _rung_of
from sphax_torch.integrate.timestep import particle_dt
from tests._slab_helpers import lockstep
from tests.dist.test_rungs_dist import _dist_setup

torch.set_num_threads(1)

RTOL = 1e-10
SEDOV2 = dataclasses.replace(sphax.configs.SEDOV, newton_iters=2)
CFGS = {
    "sedov": SEDOV2,
    "h_predict": dataclasses.replace(sphax.configs.SEDOV, h_predict=True,
                                     newton_iters=1),
    "mm_visc": dataclasses.replace(SEDOV2, balsara=False, mm_visc=True),
}
# the fields a kernel writes, which padding rows hold as don't-care junk
# (the JAX package's plain path walks the windowless groups, the port's
# plain and CUDA walks hand them h0 and zeros)
DERIVED = ("h", "rho", "P", "cs", "acc", "du_dt", "omega", "divv")


def _sedov(cfg, n_side=16, centre=(0.5, 0.5, 0.5)):
    """test_rungs_dist's set-up (the JAX package's cold derived pass, jnp
    path), with the blast at ``centre``."""
    ic = jsedov.build(n_side=n_side, E=1.0, centre=centre)
    dom = sphax.box(jnp.zeros(3), jnp.asarray(ic["box"]))
    st = sphax.make_state(*(jnp.asarray(ic[k]) for k in
                            ("pos", "vel", "mass", "u", "h")),
                          alpha0=cfg.mm_alpha_min if cfg.mm_visc else 1.0)
    spec1 = jwin.plan_measured(st.pos, dom, h_max=float(st.h.max()) * 1.1,
                               dim=3, cutoff_scale=1.05)
    return jeng.update_derived(st, cfg, dom, spec1, use_pallas=False), dom


def _jax_ops(sh, mesh, cfg, spec, cuts, dom, ops):
    """The JAX package's side of ``lockstep``'s ops."""
    recs = []
    cuts = jnp.asarray(cuts)
    for op in ops:
        rec = {"op": op}
        if op[0] == "rungs":
            nspans, n_rungs, rebuild_every, adaptive = op[1:5]
            ch = jrungs.make_chunk_rungs(
                mesh, cfg, spec, nspans=nspans, n_rungs=n_rungs,
                rebuild_every=rebuild_every, use_pallas=False,
                adaptive_rebuild=adaptive)
            sh, dts, nacts, health, viol, *nrb = ch(sh, cuts, dom)
            span = 1 << (n_rungs - 1)
            rec.update(dts=np.asarray(dts), nacts=np.asarray(nacts),
                       health=np.asarray(health), dt_viol=int(viol),
                       builds=(int(nrb[0]) if adaptive
                               else nspans * span // rebuild_every))
        elif op[0] == "rebalance":
            hist = np.asarray(jslab.make_work_histogram(
                mesh, spec, cfg, op[1])(sh, dom))
            rec["hist"] = hist
            cuts = jnp.asarray(jslab.rebalance_cuts(hist, spec))
        elif op[0] == "work":
            rec["work"] = np.asarray(jslab.make_shard_work(
                mesh, spec, cfg, op[1])(sh, dom))
        elif op[0] == "migrate":
            migrate = jslab.make_migrate(mesh, spec)
            misplaced = jslab.make_misplaced(mesh, spec)
            for k in range(spec.n_shards):
                sh, dropped = migrate(sh, cuts, dom)
                assert int(dropped) == 0
                if int(misplaced(sh, cuts, dom)) == 0:
                    break
            rec["passes"] = k + 1
        elif op[0] == "refine":
            mr, gdrop = jslab.make_max_run(mesh, spec)(sh, cuts, dom)
            assert int(gdrop) == 0
            spec = jslab.refine_wseg(spec, int(mr))
        rec["cuts"] = np.asarray(cuts)
        rec["rows"] = {k: np.asarray(getattr(sh, k)) for k in sh._fields}
        recs.append(rec)
    return recs


def _close(got, want, what):
    scale = np.abs(want).max() + 1e-300
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale,
                               err_msg=what)


LOCKSTEP = {
    # 2 ranks, the centred blast: one span of B = 3 at rebuild_every=2,
    # the work the ranks hold, then two drift-gated spans
    "2-sedov": (2, "sedov", (0.5, 0.5, 0.5), {}, [
        ("rungs", 1, 3, 2, 0), ("work", 3), ("rungs", 2, 3, 1, 4)]),
    "2-h_predict": (2, "h_predict", (0.5, 0.5, 0.5), {}, [
        ("rungs", 1, 3, 2, 0)]),
    "2-mm_visc": (2, "mm_visc", (0.5, 0.5, 0.5), {}, [
        ("rungs", 1, 3, 1, 0)]),
    # 4 ranks, the blast off centre: the work before and after a work
    # rebalance and the migration (buffers that hold a moved cut, as in
    # test_rungs_dist.py), wseg refined under the new cuts, one span of
    # B = 4
    "4-offcentre": (4, "sedov", (0.15, 0.5, 0.5), dict(migrate_frac=0.9), [
        ("work", 4), ("rebalance", 4), ("migrate",), ("work", 4),
        ("refine",), ("rungs", 1, 4, 2, 0)]),
}


@pytest.mark.parametrize("case", ["2-sedov", "2-mm_visc"])
def test_rungs_slice_matches_reference(case):
    """``lockstep``'s rung ops on gloo ranks against ``sphax.dist.wrungs``
    on fake devices (the other cases are in
    tests/test_torch_wrungs_offcentre.py)."""
    check_case(case)


def check_case(case):
    """One ``LOCKSTEP`` case, after every op: the sharded state's real rows
    at 1e-10 in every field and the layout itself, the dts, the work
    histogram and the ranks' work at 1e-10; closings per tick, dt
    violations, builds, health (zero), migration passes and the cuts
    equal."""
    ns, name, centre, plan_kw, ops = LOCKSTEP[case]
    cfg = CFGS[name]
    st, dom = _sedov(cfg, centre=centre)
    mesh, spec, cuts, sh = _dist_setup(st, dom, n_shards=ns, **plan_kw)
    cuts = np.asarray(cuts)
    rows0 = {k: np.asarray(getattr(sh, k)) for k in sh._fields}
    want = _jax_ops(sh, mesh, cfg, spec, cuts, dom, ops)

    tdom = (np.asarray(dom.lo), np.asarray(dom.hi), dom.periodic)
    got = comm.launch(
        lockstep, ns, "cpu", "gloo", timeout=60, deadline=240,
        args=(rows0, tdom, tconf.SPHConfig(**dataclasses.asdict(cfg)),
              convert.wslab_spec_from_fields(**dataclasses.asdict(spec)),
              cuts, ops))

    assert [r["op"] for r in got] == [r["op"] for r in want]
    for g, w in zip(got, want):
        what = f"{case}, after {g['op']}"
        np.testing.assert_array_equal(g["cuts"], w["cuts"], err_msg=what)
        for k in ("health", "builds", "passes", "nacts", "dt_viol"):
            assert np.array_equal(g.get(k), w.get(k)), (what, k, g.get(k),
                                                        w.get(k))
        # sums of 2^-rung: the JAX package's exp2(-3.0) is one ulp above
        # 1/8 on the CPU, the port's exact
        for k in ("hist", "work"):
            assert (k in g) == (k in w), (what, k)
            if k in w:
                _close(g[k], w[k], f"{what}: {k}")
        if "health" in w:
            assert not np.any(w["health"]), what
        if "dts" in w:
            _close(g["dts"], w["dts"], f"{what}: dts")
        real = w["rows"]["mass"] > 0
        np.testing.assert_array_equal(g["rows"]["mass"] > 0, real)
        for k, v in w["rows"].items():
            sel = real if k in DERIVED else slice(None)
            _close(g["rows"][k][sel], v[sel], f"{what}: {k}")
    rungs = [w for w in want if w["op"][0] == "rungs"]
    # the blast spreads the rungs, so the masks bite
    assert all(w["nacts"].min() < st.n for w in rungs), case
    if case == "4-offcentre":
        w0, w1 = want[0]["work"], want[3]["work"]
        assert w1.max() / w1.mean() < w0.max() / w0.mean() - 0.05, (w0, w1)
        # some rank holds no rung-0 particle at the span's start, so it has
        # no closer on the first tick and its kernels ran on a fully masked
        # structure
        st0 = convert.state_from_numpy(want[-2]["rows"], "cpu",
                                       torch.float64)
        real = st0.mass > 0
        dt = torch.where(real, particle_dt(st0, tconf.SEDOV), 1e30)
        rung = _rung_of(dt, dt.amin(), 4).reshape(ns, -1)
        quiet = [int(r[m].min()) > 0 for r, m in zip(rung,
                                                     real.reshape(ns, -1))]
        assert any(quiet) and not all(quiet), quiet


@pytest.mark.parametrize("hist", ["random", "one_cell", "powers"])
def test_quantile_cuts_of_a_work_histogram(hist):
    """``rebalance_cuts`` on a float histogram gives the JAX package's
    cuts (the work histogram is a float sum of powers of two)."""
    st, dom = _sedov(SEDOV2, n_side=16)
    jspec = jslab.plan(dom, st.n, h_max=float(st.h.max()) * 1.1,
                       n_shards=4, cutoff_scale=1.05)
    tspec = convert.wslab_spec_from_fields(**dataclasses.asdict(jspec))
    rng = np.random.default_rng(7)
    nc = jspec.ncell_ax
    h = {"random": rng.random(nc) * 100.0,
         "one_cell": np.r_[np.full(nc - 1, 0.125), 300.0],
         "powers": 2.0 ** -rng.integers(0, 4, nc) * rng.integers(1, 90, nc)
         }[hist]
    np.testing.assert_array_equal(tslab.rebalance_cuts(h, tspec),
                                  jslab.rebalance_cuts(h, jspec))
