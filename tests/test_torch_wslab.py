"""The port's slab decomposition (``sphax_torch.dist``) against
``sphax.dist.wslab``.

The window build with the ``active`` and ``image`` masks gives the JAX
build's integer tables; the host-side plan, cuts and wseg refinement equal
the JAX functions exactly, and so does ``distribute``. Then the slice:
``sphax.dist.wslab``'s step, chunk (fixed cadence, driven, drift-gated),
rebalance and migration with ``use_pallas=False`` on the conftest's fake
devices, against the port's ranks (gloo, CPU tensors) from the same
sharded arrays, at 2 and at 4 ranks: 1e-10 on every field of the sharded
state and on the dts, and the same cuts, health and builds.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sphax
from sphax.dist import wslab as jslab
from sphax.neighbors import window as jwin
from sphax.physics import dense as jdense
from sphax.physics import driving as jdrv
from sphax.run import DriveSpec as JDriveSpec
from sphax_torch import configs as tconf
from sphax_torch import convert
from sphax_torch.dist import comm
from sphax_torch.dist import wslab as tslab
from sphax_torch.neighbors import window as twin
from sphax_torch.physics import driving
from tests._slab_helpers import lockstep
from tests.dist.test_wslab import DIST_CONFIGS, _problem
from tests.test_torch_slice import _jax_noise
from tests.test_torch_window import _assert_same_structure

torch.set_num_threads(1)

RTOL = 1e-10


def _tdom(jdom):
    return convert.domain_from_numpy(np.asarray(jdom.lo), np.asarray(jdom.hi),
                                     jdom.periodic, "cpu", torch.float64)


@pytest.mark.parametrize("fast_sub,rgroups", [(3, 2), (1, 1)])
def test_build_with_masks_equals_reference(fast_sub, rgroups):
    """A shard-like structure: an open slab axis and periodic transverse
    axes, pad rows without mass, ghost rows that are imaged but inactive,
    and a row that is active but not imaged."""
    rng = np.random.default_rng(3)
    n = 900
    lo, hi = np.zeros(3), np.array([0.6, 1.0, 1.0])
    pos = lo + (hi - lo) * rng.random((n, 3))
    mass = np.where(rng.random(n) < 0.15, 0.0, 1.0 / n)
    active = (mass > 0) & (np.arange(n) < 600)
    image = mass > 0
    image[5] = False
    per = (False, True, True)
    jd = sphax.Domain(jnp.asarray(lo), jnp.asarray(hi), periodic=per)
    td = convert.domain_from_numpy(lo, hi, per, "cpu", torch.float64)
    kw = dict(h_max=0.045, n=n, dim=3, cutoff_scale=1.2, fast_sub=fast_sub,
              rgroups=rgroups)
    jspec = jwin.plan_windows(jd, **kw)
    tspec = twin.plan_windows(td, **kw)
    assert convert.spec_from_fields(**dataclasses.asdict(jspec)) == tspec
    for a, im in ((active, image), (active, None)):
        jw = jax.jit(jwin.build, static_argnums=2)(
            jnp.asarray(pos), jd, jspec, jnp.asarray(a),
            None if im is None else jnp.asarray(im))
        tw = twin.build(torch.as_tensor(pos), td, tspec,
                        active=torch.as_tensor(a),
                        image=None if im is None else torch.as_tensor(im))
        _assert_same_structure(jw, tw, n)
    # the masks change the tables: fewer groups define windows
    unmasked = twin.build(torch.as_tensor(pos), td, tspec)
    assert int(tw.w_nact.sum()) < int(unmasked.w_nact.sum())


def _jspec(n_side=12, ns=2, **kw):
    st, dom = _problem(DIST_CONFIGS["fixed_h"], n_side=n_side)
    return st, dom, jslab.plan(dom, st.n, h_max=float(st.h.max()) * 1.1,
                               n_shards=ns, **kw)


@pytest.mark.parametrize("ns,kw", [
    (2, {}), (4, dict(fast_sub=3, rgroups=2)),
    (2, dict(slab_axis=1, pad_factor=2.0, balance_headroom=2.0)),
    (3, dict(cutoff_scale=1.05, ghost_safety=1.4, migrate_frac=0.5))])
def test_host_functions_equal_reference(ns, kw):
    """plan, equal_cuts, refine_wseg, rebalance_cuts and quantile_cuts give
    what the JAX functions give, and raise where they raise."""
    jst, jdom, jspec = _jspec(n_side=16, ns=ns, **kw)
    tdom = _tdom(jdom)
    tspec = tslab.plan(tdom, jst.n, h_max=float(jst.h.max()) * 1.1,
                       n_shards=ns, **kw)
    want = convert.wslab_spec_from_fields(**dataclasses.asdict(jspec))
    assert tspec == want
    np.testing.assert_array_equal(tslab.equal_cuts(tspec.ncell_ax, ns),
                                  jslab.equal_cuts(jspec.ncell_ax, ns))
    for mr in (1, 200, 777, 5000):
        assert tslab.refine_wseg(tspec, mr) == \
            convert.wslab_spec_from_fields(**dataclasses.asdict(
                jslab.refine_wseg(jspec, mr)))
    rng = np.random.default_rng(ns)
    for hist in (rng.integers(0, 50, tspec.ncell_ax),
                 np.r_[np.zeros(tspec.ncell_ax - 1), 100],
                 np.ones(tspec.ncell_ax)):
        np.testing.assert_array_equal(tslab.rebalance_cuts(hist, tspec),
                                      jslab.rebalance_cuts(hist, jspec))
    for args in ((rng.random(40), 5, 2, 12), (rng.random(9), 3, 1, 4),
                 (rng.random(10), 4, 3, 3)):
        try:
            want = jslab.quantile_cuts(*args)
        except ValueError:
            with pytest.raises(ValueError):
                tslab.quantile_cuts(*args)
        else:
            np.testing.assert_array_equal(tslab.quantile_cuts(*args), want)
    with pytest.raises(ValueError):
        jslab.plan(jdom, jst.n, h_max=0.3, n_shards=8)
    with pytest.raises(ValueError):
        tslab.plan(tdom, jst.n, h_max=0.3, n_shards=8)


def test_distribute_equals_reference():
    """Each rank's shard of a single-device state, with the padding rows
    parked in its trash band, is the JAX layout's rows."""
    jst, jdom, jspec = _jspec(n_side=12, ns=3)
    cuts = np.array([0, 1, 2, 3], np.int32)
    jsh = jslab.distribute(jst, jdom, jslab.make_mesh(3), jspec, cuts)
    tspec = convert.wslab_spec_from_fields(**dataclasses.asdict(jspec))
    tst = convert.state_from_numpy({k: np.asarray(getattr(jst, k))
                                    for k in jst._fields}, "cpu",
                                   torch.float64)
    got = [tslab.distribute(tst, _tdom(jdom), tspec, cuts, r)
           for r in range(3)]
    for k in jst._fields:
        want = np.asarray(getattr(jsh, k))
        have = np.concatenate([getattr(g, k).numpy() for g in got])
        np.testing.assert_allclose(have, want, rtol=1e-15, atol=1e-15,
                                   err_msg=k)
    real = np.asarray(jsh.mass) > 0
    np.testing.assert_array_equal(
        np.concatenate([g.pos.numpy() for g in got])[real],
        np.asarray(jsh.pos)[real])


def _jax_ops(sh, mesh, cfg, spec, cuts, dom, ops, drive=None):
    """The JAX package's side of ``_slab_helpers.lockstep``'s ops;
    ``drive`` = (DriveSpec, DriveState) for the driven chunks."""
    recs = []
    step = jslab.make_step(mesh, cfg, spec, use_pallas=False)
    for op in ops:
        rec = {"op": op}
        if op[0] == "step":
            sh, dt, health = step(sh, jnp.asarray(cuts), dom)
            rec.update(dts=np.atleast_1d(np.asarray(dt)),
                       health=np.asarray(health))
        elif op[0] == "chunk":
            nsteps, rebuild_every, adaptive = op[1:4]
            driven = len(op) > 4 and op[4]
            ch = jslab.make_chunk(mesh, cfg, spec, nsteps, use_pallas=False,
                                  rebuild_every=rebuild_every,
                                  drive_spec=drive[0] if driven else None,
                                  adaptive_rebuild=adaptive)
            if driven:
                sh, dr, *out = ch(sh, jnp.asarray(cuts), dom, drive[1])
                drive = (drive[0], dr)
                rec["drive"] = (np.asarray(dr.amp_re), np.asarray(dr.amp_im))
            else:
                sh, *out = ch(sh, jnp.asarray(cuts), dom)
            rec.update(dts=np.asarray(out[0]), health=np.asarray(out[1]),
                       builds=(int(out[2]) if adaptive
                               else nsteps // rebuild_every))
        elif op[0] == "rebalance":
            hist = np.asarray(jslab.make_histogram(mesh, spec)(sh, dom))
            cuts = jslab.rebalance_cuts(hist, spec)
        elif op[0] == "migrate":
            migrate = jslab.make_migrate(mesh, spec)
            misplaced = jslab.make_misplaced(mesh, spec)
            for k in range(spec.n_shards):
                sh, dropped = migrate(sh, jnp.asarray(cuts), dom)
                assert int(dropped) == 0
                if int(misplaced(sh, jnp.asarray(cuts), dom)) == 0:
                    break
            rec["passes"] = k + 1
        rec["cuts"] = np.asarray(cuts)
        rec["rows"] = {k: np.asarray(getattr(sh, k)) for k in sh._fields}
        recs.append(rec)
    return recs


def _close(got, want, what):
    scale = np.abs(want).max() + 1e-300
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale,
                               err_msg=what)


LOCKSTEP = {
    # 2 ranks (both neighbours the same peer; 12^3 particles): fixed h, a
    # chunk at the reuse cadence, then a driven drift-gated chunk after the
    # rebalance and migration; 4 ranks (16^3, the least lattice that cuts
    # into 4 slabs): Morris-Monaghan alpha(t) (the phase-1 alpha fill and
    # the phase-2 visc-factor re-ship)
    2: ("fixed_h", 12, [("step",), ("chunk", 2, 2, 0), ("rebalance",),
                        ("migrate",), ("chunk", 3, 1, 2, True)]),
    4: ("mm_visc", 16, [("step",), ("chunk", 2, 2, 0), ("rebalance",),
                        ("migrate",)]),
}

# the fields a kernel writes, which padding rows hold as don't-care junk
# (the JAX package's plain path walks the windowless groups, the port's
# plain and CUDA walks hand them h0 and zeros)
DERIVED = ("h", "rho", "P", "cs", "acc", "du_dt", "omega", "divv")


@pytest.mark.parametrize("ns", sorted(LOCKSTEP))
def test_slice_matches_reference(ns):
    """``_slab_helpers.lockstep`` on ``ns`` gloo ranks against the same ops of
    ``sphax.dist.wslab`` on ``ns`` fake devices, from one sharded state,
    after every op: every field of the real rows at 1e-10, and the layout
    itself (which rows are real, the padding rows' positions, velocities
    and masses); the dts at 1e-10, the health counters zero, the same
    cuts, migration passes and builds. At 2 ranks the last chunk is driven
    (the JAX noise draws replayed into the port), so the replicated OU
    amplitudes are held too."""
    name, n_side, ops = LOCKSTEP[ns]
    cfg = DIST_CONFIGS[name]
    st, dom = _problem(cfg, n_side=n_side)
    st = jdense.update_derived(st, cfg, dom, block=64)
    mesh = jslab.make_mesh(ns)
    # a rebalance may move a cut by a whole cell of the coarse slab grid
    # (a quarter of the particles): shards and send buffers that hold it
    spec = jslab.plan(dom, st.n, h_max=float(st.h.max()) * 1.1, n_shards=ns,
                      pad_factor=2.0, migrate_frac=1.0)
    cuts = jslab.equal_cuts(spec.ncell_ax, ns)
    sh = jslab.distribute(st, dom, mesh, spec, cuts)
    mr, _ = jslab.make_max_run(mesh, spec)(sh, jnp.asarray(cuts), dom)
    spec = jslab.refine_wseg(spec, int(mr))
    rows0 = {k: np.asarray(getattr(sh, k)) for k in sh._fields}

    drive = jdrive = None
    driven = sum(op[1] for op in ops if len(op) > 4 and op[4])
    if driven:
        modes = tuple(map(tuple, driving.make_modes(1, 2).astype(int)))
        jd0 = jdrv.init(jax.random.PRNGKey(5), modes, jnp.float64)
        drive = (driving.DriveSpec(modes=modes, tau=0.5, accel_rms=0.5),
                 np.asarray(jd0.amp_re), np.asarray(jd0.amp_im),
                 _jax_noise(jd0.key, len(modes), driven))
        jdrive = (JDriveSpec(modes=modes, tau=0.5, accel_rms=0.5), jd0)
    want = _jax_ops(sh, mesh, cfg, spec, cuts, dom, ops, drive=jdrive)

    tdom = (np.asarray(dom.lo), np.asarray(dom.hi), dom.periodic)
    got = comm.launch(
        lockstep, ns, "cpu", "gloo", timeout=60, deadline=240,
        args=(rows0, tdom, tconf.SPHConfig(**dataclasses.asdict(cfg)),
              convert.wslab_spec_from_fields(**dataclasses.asdict(spec)),
              cuts, ops, drive))

    assert [r["op"] for r in got] == [r["op"] for r in want]
    for g, w in zip(got, want):
        what = f"{ns} ranks, after {g['op']}"
        np.testing.assert_array_equal(g["cuts"], w["cuts"], err_msg=what)
        for k in ("health", "builds", "passes"):
            assert np.array_equal(g.get(k), w.get(k)), (what, k)
        if "health" in w:
            assert not np.any(w["health"]), what
        if "dts" in w:
            _close(g["dts"], w["dts"], f"{what}: dts")
        real = w["rows"]["mass"] > 0
        np.testing.assert_array_equal(g["rows"]["mass"] > 0, real)
        for k, v in w["rows"].items():
            sel = real if k in DERIVED else slice(None)
            _close(g["rows"][k][sel], v[sel], f"{what}: {k}")
        assert ("drive" in g) == ("drive" in w), what
        for a, b in zip(g.get("drive", ()), w.get("drive", ())):
            _close(a, b, f"{what}: drive")
