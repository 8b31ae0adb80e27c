"""Block timesteps over the slab decomposition against the port's own
single-device rung integrator (the port of tests/dist/test_rungs_dist.py
and of test_dist_adaptive.py's two wrungs tests), on gloo ranks over CPU
tensors, at those tests' tolerances: the same global tick schedule (dts at
1e-12), the same closings per tick and dt violations, every field at 1e-8;
drift-gated rebuilds against the fixed cadence at 1e-9; B = 1 against
``wslab.chunk`` at 1e-9; and the work rebalance of an off-centre blast on 4
ranks lowering the work imbalance by more than 0.05 and keeping the
trajectory.
"""
import dataclasses

import numpy as np
import pytest
import torch

from sphax_torch import configs, convert, make_state
from sphax_torch.core.state import box
from sphax_torch.dist import comm
from sphax_torch.dist import wslab
from sphax_torch.ics import sedov
from sphax_torch.integrate import rungs
from sphax_torch.neighbors import window as win
from sphax_torch.physics import wengine
from tests._slab_helpers import lockstep
from tests.test_torch_wslab_lockstep import _canon

torch.set_num_threads(1)

SEDOV2 = dataclasses.replace(configs.SEDOV, newton_iters=2)
HPRED = dataclasses.replace(configs.SEDOV, h_predict=True, newton_iters=1)
FIELDS = ("vel", "rho", "u", "h", "P", "acc", "du_dt")


def _setup(cfg, n_side=16, centre=(0.5, 0.5, 0.5)):
    """test_rungs_dist.py's set-up on the port: the Sedov lattice, the
    single-device plan (h_max x 1.1, cutoff_scale 1.05), its derived
    pass."""
    ic = sedov.build(n_side=n_side, E=1.0, centre=centre)
    st = make_state(*(torch.as_tensor(ic[k]) for k in
                      ("pos", "vel", "mass", "u", "h")))
    dom = box(torch.zeros(3, dtype=torch.float64),
              torch.as_tensor(ic["box"]))
    spec1 = win.plan_measured(st.pos, dom, h_max=float(st.h.max()) * 1.1,
                              dim=3, cutoff_scale=1.05)
    return wengine.update_derived(st, cfg, dom, spec1), dom, spec1


def _dist(st0, cfg, dom, ns, ops, **plan_kw):
    """``lockstep``'s records of ``ops`` on ``ns`` ranks from the equal-cut
    distribution of ``st0`` (test_rungs_dist.py's plan, wseg refined to the
    measured run); every record's health zero."""
    spec = wslab.plan(dom, st0.n, h_max=float(st0.h.max()) * 1.1,
                      n_shards=ns, cutoff_scale=1.05, **plan_kw)
    cuts = wslab.equal_cuts(spec.ncell_ax, ns)
    shards = [convert.state_to_numpy(wslab.distribute(st0, dom, spec, cuts,
                                                      r)) for r in range(ns)]
    rows = {k: np.concatenate([s[k] for s in shards]) for k in shards[0]}
    domain = (dom.lo.numpy(), dom.hi.numpy(), dom.periodic)
    recs = comm.launch(lockstep, ns, "cpu", "gloo", timeout=60,
                       deadline=300, args=(rows, domain, cfg, spec, cuts,
                                           ops, None, True))
    for r in recs:
        if "health" in r:
            assert not np.any(r["health"]), (r["op"], r["health"])
    return recs


def _real(rec):
    m = rec["rows"]["mass"] > 0
    return {k: v[m] for k, v in rec["rows"].items()}


def _compare(got, ref, dom, rtol=1e-8):
    """Real rows of a record against a state (or another record's real
    rows), matched by their wrapped positions: pos at rtol (absolute),
    FIELDS at rtol and rtol of the largest value."""
    if not isinstance(ref, dict):
        ref = {k: getattr(ref, k).numpy() for k in ("pos",) + FIELDS}
    pa, pb = _canon(got["pos"], dom), _canon(ref["pos"], dom)
    oi = np.lexsort((pa[:, 2], pa[:, 1], pa[:, 0]))
    oj = np.lexsort((pb[:, 2], pb[:, 1], pb[:, 0]))
    assert len(oi) == len(oj)
    np.testing.assert_allclose(pa[oi], pb[oj], rtol=rtol, atol=rtol,
                               err_msg="pos")
    for f in FIELDS:
        a, b = got[f][oi], ref[f][oj]
        scale = np.abs(b).max() + 1e-30
        np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * scale,
                                   err_msg=f)


def _same_schedule(rec, dts, nacts, viol):
    np.testing.assert_allclose(rec["dts"], dts.numpy(), rtol=1e-12)
    np.testing.assert_array_equal(rec["nacts"], nacts.numpy())
    assert rec["dt_viol"] == int(viol)


@pytest.fixture(scope="module")
def sedov_runs():
    """One launch of 2 ranks for three tests: a span of B = 3 at
    rebuild_every=2, one at every tick, one drift-gated (age cap 4), and
    two drift-gated spans (age cap 8), each from the first state."""
    st, dom, spec1 = _setup(SEDOV2)
    ops = [("rungs", 1, 3, 2, 0), ("reset",), ("rungs", 1, 3, 1, 0),
           ("reset",), ("rungs", 1, 3, 1, 4), ("reset",),
           ("rungs", 2, 3, 1, 8)]
    recs = _dist(st, SEDOV2, dom, 2, ops)
    return st, dom, spec1, recs[::2]


def test_dist_rungs_matches_single_device(sedov_runs):
    """A span of B = 3 on 2 ranks is the single-device span: dts at
    1e-12, closings per tick and dt violations equal, every field at
    1e-8; the blast spreads the rungs."""
    st, dom, spec1, recs = sedov_runs
    ref, dts, nacts, ovf, viol, _ = rungs.simulate_rungs(
        st, SEDOV2, dom, spec1, nspans=1, n_rungs=3, rebuild_every=2)
    assert int(ovf) == 0 and int(nacts.min()) < st.n
    _same_schedule(recs[0], dts, nacts, viol)
    _compare(_real(recs[0]), ref, dom)


def test_wrungs_adaptive_matches_fixed(sedov_runs):
    """Drift-gated rebuilds change when the structure is built, never the
    pairs: the gated span equals the span rebuilt every tick (dts at
    1e-12, closings and violations equal, fields at 1e-9) with between 1
    and 4 builds."""
    _, dom, _, recs = sedov_runs
    fixed, gated = recs[1], recs[2]
    assert fixed["builds"] == 4 and 1 <= gated["builds"] <= 4
    np.testing.assert_allclose(gated["dts"], fixed["dts"], rtol=1e-12)
    np.testing.assert_array_equal(gated["nacts"], fixed["nacts"])
    assert gated["dt_viol"] == fixed["dt_viol"]
    _compare(_real(gated), _real(fixed), dom, rtol=1e-9)


def test_wrungs_adaptive_matches_single_device_adaptive(sedov_runs):
    """Two drift-gated spans on 2 ranks track the single-device gated
    integrator tick for tick (their builds may differ, since the two
    plans' cutoffs differ; the candidates stay a superset of the
    neighbours either way)."""
    st, dom, spec1, recs = sedov_runs
    ref, dts, nacts, ovf, viol, _ = rungs.simulate_rungs(
        st, SEDOV2, dom, spec1, nspans=2, n_rungs=3, adaptive_rebuild=8)
    assert int(ovf) == 0
    _same_schedule(recs[3], dts, nacts, viol)
    _compare(_real(recs[3]), ref, dom)


def test_dist_rungs_h_predict_matches_single_device():
    """h_predict with rungs on 2 ranks: the per-closer predictor is
    elementwise on local rows, and the owner re-predicts its ghosts the
    same way, so the span equals the single-device h_predict span."""
    st, dom, spec1 = _setup(HPRED)
    ref, dts, nacts, ovf, viol, _ = rungs.simulate_rungs(
        st, HPRED, dom, spec1, nspans=1, n_rungs=3, rebuild_every=2)
    assert int(ovf) == 0 and int(nacts.min()) < st.n
    rec = _dist(st, HPRED, dom, 2, [("rungs", 1, 3, 2, 0)])[0]
    _same_schedule(rec, dts, nacts, viol)
    _compare(_real(rec), ref, dom)


def test_work_rebalance_reduces_rung_imbalance():
    """An off-centre blast on 4 slabs puts its low rungs in one slab under
    equal cuts. Cuts from the work histogram lower the ranks' work
    imbalance (max over mean) by more than 0.05, and since any legal cuts
    give the same trajectory, a span of B = 4 under them (wseg refined
    for them) still equals the single-device span."""
    st, dom, spec1 = _setup(SEDOV2, centre=(0.15, 0.5, 0.5))
    # the one-shot rebalance moves a big slab's worth of particles at once:
    # send buffers that hold it, as in test_rungs_dist.py
    recs = _dist(st, SEDOV2, dom, 4, [
        ("work", 4), ("rebalance", 4), ("migrate",), ("work", 4),
        ("refine",), ("rungs", 1, 4, 2, 0)], migrate_frac=0.9)
    w0, w1 = recs[0]["work"], recs[3]["work"]
    imb0, imb1 = w0.max() / w0.mean(), w1.max() / w1.mean()
    assert imb0 > 1.15, w0
    assert imb1 < imb0 - 0.05, (w0, w1)
    ref, dts, nacts, ovf, viol, _ = rungs.simulate_rungs(
        st, SEDOV2, dom, spec1, nspans=1, n_rungs=4, rebuild_every=2)
    assert int(ovf) == 0
    _same_schedule(recs[-1], dts, nacts, viol)
    _compare(_real(recs[-1]), ref, dom)


def test_dist_rungs_b1_matches_global_chunk():
    """B = 1 is the distributed global-dt chunk: two ticks of one rung on
    2 ranks equal two ``wslab.chunk`` steps (rebuilt every step) at 1e-9,
    every particle closing every tick, no violation."""
    cfg = dataclasses.replace(SEDOV2, balsara=True)
    st, dom, _ = _setup(cfg, n_side=12)
    r, _, g = _dist(st, cfg, dom, 2, [("rungs", 2, 1, 1, 0), ("reset",),
                                      ("chunk", 2, 1, 0)])
    assert r["dt_viol"] == 0 and np.all(r["nacts"] == st.n)
    np.testing.assert_allclose(r["dts"], g["dts"], rtol=1e-12)
    _compare(_real(r), _real(g), dom, rtol=1e-9)
