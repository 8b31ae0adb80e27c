"""The port's slab decomposition against the port's own single-device
window engine (the JAX package's tests/dist/test_wslab.py and
test_dist_adaptive.py, ported; the rest are in
tests/test_torch_wslab_migrate.py): the distributed step and the chunk
with structure reuse, on gloo ranks over CPU tensors, at the JAX tests'
tolerances. The reference is ``wengine.simulate`` rebuilding every
step (the port's dense engine, the JAX tests' reference, takes about a
minute a derived pass at these sizes on the CPU); a window structure's
candidates are a superset of the neighbours, so both are the same physics
to roundoff.
"""
import numpy as np
import pytest
import torch

from sphax_torch import configs as tconf
from sphax_torch import convert, make_state
from sphax_torch.core.state import box
from sphax_torch.dist import comm
from sphax_torch.dist import wslab as tslab
from sphax_torch.neighbors import window as win
from sphax_torch.physics import wengine
from tests._slab_helpers import lockstep
from tests.parity.test_dense_vs_reference import make_problem

torch.set_num_threads(1)

CFGS = {
    "fixed_h": tconf.SPHConfig(dim=3, adaptive_h=False, grad_h=False),
    "isothermal": tconf.SPHConfig(dim=3, isothermal=True, cs_iso=1.5,
                                  adaptive_h=True, newton_iters=8),
    "mm_visc": tconf.SPHConfig(dim=3, adaptive_h=True, mm_visc=True,
                               newton_iters=8),
}


def _state(pos, vel, mass, u, h, periodic=True, hi=1.0):
    st = make_state(*(torch.as_tensor(np.asarray(a, np.float64))
                      for a in (pos, vel, mass, u, h)))
    hi = torch.tensor(np.broadcast_to(np.asarray(hi, np.float64), (3,)))
    return st, box(torch.zeros(3, dtype=torch.float64), hi,
                   periodic=periodic)


def _lattice(n_side=16, seed=4, vel_scale=0.2):
    return _state(*make_problem(dim=3, n_side=n_side, seed=seed,
                                vel_scale=vel_scale))


def _single(st, cfg, dom, nsteps, h_margin=1.1, cutoff_scale=1.0):
    """The derived initial state and ``nsteps`` steps of the single-device
    window engine, rebuilding every step; (state0, state, dts)."""
    spec = win.plan_measured(st.pos, dom, h_max=float(st.h.max()) * h_margin,
                             dim=3, cutoff_scale=cutoff_scale)
    st0 = wengine.update_derived(st, cfg, dom, spec)
    ref, _, dts, ovf = wengine.simulate(st0, cfg, dom, spec, nsteps,
                                        rebuild_every=1)
    assert int(ovf) == 0
    return st0, ref, dts.numpy()


def _dist(st0, cfg, dom, ns, ops, h_max=None, **plan_kw):
    """``_slab_helpers.lockstep``'s records of ``ops`` on ``ns`` ranks from
    the equal-cut distribution of ``st0`` (wseg refined to the measured run)."""
    h_max = float(st0.h.max()) * 1.1 if h_max is None else h_max
    spec = tslab.plan(dom, st0.n, h_max=h_max, n_shards=ns, **plan_kw)
    cuts = tslab.equal_cuts(spec.ncell_ax, ns)
    shards = [convert.state_to_numpy(tslab.distribute(st0, dom, spec, cuts,
                                                      r)) for r in range(ns)]
    rows = {k: np.concatenate([s[k] for s in shards]) for k in shards[0]}
    domain = (dom.lo.numpy(), dom.hi.numpy(), dom.periodic)
    recs = comm.launch(lockstep, ns, "cpu", "gloo", timeout=60,
                       deadline=300, args=(rows, domain, cfg, spec, cuts,
                                           ops, None, True))
    for r in recs:
        if "health" in r:
            assert not np.any(r["health"]), (r["op"], r["health"])
    return recs, spec


def _real(rec):
    m = rec["rows"]["mass"] > 0
    return {k: v[m] for k, v in rec["rows"].items()}


def _canon(pos, dom):
    """Positions wrapped into the box on periodic axes: the slab engine
    wraps only the transverse axes at rebuilds, the single-device engine
    every axis, so a particle that crossed the seam differs by one box."""
    lo, ext = dom.lo.numpy(), (dom.hi - dom.lo).numpy()
    per = np.asarray(dom.periodic_axes(3))
    return np.where(per, lo + np.mod(pos - lo, ext), pos)


def _compare(got, ref, dom, fields, rtol):
    pa, pb = _canon(got["pos"], dom), _canon(ref.pos.numpy(), dom)
    oi = np.lexsort((pa[:, 2], pa[:, 1], pa[:, 0]))
    oj = np.lexsort((pb[:, 2], pb[:, 1], pb[:, 0]))
    assert len(oi) == len(oj)
    np.testing.assert_allclose(pa[oi], pb[oj], rtol=rtol, atol=rtol,
                               err_msg="pos")
    for f in fields:
        a, b = got[f][oi], getattr(ref, f).numpy()[oj]
        scale = np.abs(b).max() + 1e-30
        np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * scale,
                                   err_msg=f)


@pytest.mark.parametrize("name", ["fixed_h", "mm_visc"])
def test_wslab_step_matches_single_device(name):
    """3 distributed steps on 4 ranks (a fresh structure each) equal 3
    single-device steps: dts at 1e-10, every field at 1e-8."""
    cfg = CFGS[name]
    st, dom = _lattice()
    st0, ref, ref_dts = _single(st, cfg, dom, 3)
    recs, _ = _dist(st0, cfg, dom, 4, [("step",)] * 3)
    np.testing.assert_allclose([r["dts"][0] for r in recs], ref_dts,
                               rtol=1e-10)
    _compare(_real(recs[-1]), ref, dom, ("vel", "u", "h", "rho", "P", "acc",
                                         "alpha", "divv"), 1e-8)


def test_wslab_chunk_reuse_matches_single_device():
    """A 4-step chunk at rebuild_every=2 (routes and structures reused,
    kinematics re-shipped every step) equals the per-step-rebuilt
    single-device run: the stale structure is a superset of the
    neighbourhood while the drift stays inside the skin."""
    cfg = CFGS["isothermal"]
    st, dom = _lattice()
    st0, ref, ref_dts = _single(st, cfg, dom, 4)
    recs, _ = _dist(st0, cfg, dom, 4, [("chunk", 4, 2, 0)])
    assert recs[0]["builds"] == 2
    np.testing.assert_allclose(recs[0]["dts"], ref_dts, rtol=1e-10)
    _compare(_real(recs[0]), ref, dom, ("vel", "u", "h", "rho", "P", "acc"),
             1e-8)
