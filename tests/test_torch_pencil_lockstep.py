"""The port's pencil decomposition (``sphax_torch.dist.pencil``) against
``sphax.dist.pencil``: the step and the chunk with structure reuse (driven
too), with ``use_pallas=False`` and
``sorted_mesh=False`` on the conftest's fake devices, against the port's
ranks (gloo, CPU tensors) from the same sharded arrays, on a 2x2 grid and
on the degenerate 1x2 and 2x1 grids (a ring of one along an axis): 1e-10
on every field of the sharded state and on the dts, and the same health
and builds. Both of tests/dist/test_pencil.py's configurations at its size
(n_side=16); the second one's cases are in
tests/test_torch_pencil_lockstep_gradh.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphax.dist import pencil as jpen
from sphax.physics import dense as jdense
from sphax.physics import driving as jdrv
from sphax.run import DriveSpec as JDriveSpec
from sphax_torch import configs as tconf
from sphax_torch import convert
from sphax_torch.dist import comm
from sphax_torch.physics import driving
from tests._slab_helpers import pencil_lockstep
from tests.dist.test_pencil import PENCIL_CONFIGS
from tests.dist.test_wslab import _problem
from tests.test_torch_slice import _jax_noise

torch.set_num_threads(1)

RTOL = 1e-10
# the fields a kernel writes, which padding rows hold as don't-care junk
# (the JAX package's plain path walks the windowless groups, the port's
# plain and CUDA walks hand them h0 and zeros)
DERIVED = ("h", "rho", "P", "cs", "acc", "du_dt", "omega", "divv")


def jax_setup(cfg, st, dom, ns0, ns1, cuts=None, refine=True, **plan_kw):
    """The JAX package's sharded state on an ns0 x ns1 mesh from ``cuts``
    (default equal cuts), wseg refined to the measured run where
    ``refine``: (mesh, spec, (cuts0, cuts1), rows)."""
    mesh = jpen.make_mesh(ns0, ns1)
    spec = jpen.plan(dom, st.n, h_max=float(st.h.max()) * 1.1, ns0=ns0,
                     ns1=ns1, **plan_kw)
    cuts = cuts or (jpen.equal_cuts(spec.ncell0, ns0),
                    jpen.equal_cuts(spec.ncell1, ns1))
    sh = jpen.distribute(st, dom, mesh, spec, *cuts)
    if refine:
        mr, gdrop = jpen.make_max_run(mesh, spec)(
            sh, *(jnp.asarray(c) for c in cuts), dom)
        assert int(gdrop) == 0
        spec = jpen.refine_wseg(spec, int(mr))
    return mesh, spec, cuts, sh


def jax_ops(sh, mesh, cfg, spec, cuts, dom, ops, drive=None):
    """The JAX package's side of ``pencil_lockstep``'s ops; ``drive`` =
    (DriveSpec, DriveState) for the driven chunks."""
    from sphax.dist import prungs as jprungs

    recs = []
    c0, c1 = (np.asarray(c) for c in cuts)
    kw = dict(use_pallas=False)
    for op in ops:
        rec = {"op": op}
        jc = (jnp.asarray(c0), jnp.asarray(c1))
        if op[0] == "step":
            sh, dt, health = jpen.make_step(mesh, cfg, spec, sorted_mesh=False,
                                            **kw)(sh, *jc, dom)
            rec.update(dts=np.atleast_1d(np.asarray(dt)),
                       health=np.asarray(health))
        elif op[0] == "chunk":
            nsteps, rebuild_every = op[1:3]
            driven = len(op) > 3 and op[3]
            ch = jpen.make_chunk(mesh, cfg, spec, nsteps,
                                 rebuild_every=rebuild_every,
                                 drive_spec=drive[0] if driven else None,
                                 sorted_mesh=False, **kw)
            if driven:
                sh, dr, dts, health = ch(sh, *jc, dom, drive[1])
                drive = (drive[0], dr)
                rec["drive"] = (np.asarray(dr.amp_re), np.asarray(dr.amp_im))
            else:
                sh, dts, health = ch(sh, *jc, dom)
            rec.update(dts=np.asarray(dts), health=np.asarray(health),
                       builds=nsteps // rebuild_every)
        elif op[0] == "rungs":
            nspans, n_rungs, rebuild_every = op[1:4]
            sh, dts, nacts, health, viol = jprungs.make_chunk_rungs(
                mesh, cfg, spec, nspans=nspans, n_rungs=n_rungs,
                rebuild_every=rebuild_every, **kw)(sh, *jc, dom)
            rec.update(dts=np.asarray(dts), nacts=np.asarray(nacts),
                       health=np.asarray(health), dt_viol=int(viol),
                       builds=nspans * (1 << (n_rungs - 1)) // rebuild_every)
        elif op[0] == "rebalance":
            h0, h1 = jpen.make_histograms(mesh, spec)(sh, dom)
            rec["hist"] = (np.asarray(h0), np.asarray(h1))
            c0, c1 = jpen.rebalance(*rec["hist"], spec)
        elif op[0] == "cuts":
            c0, c1 = (np.asarray(c) for c in op[1:3])
        elif op[0] == "migrate":
            migrate = jpen.make_migrate(mesh, spec)
            misplaced = jpen.make_misplaced(mesh, spec)
            for k in range(max(spec.ns0, spec.ns1)):
                sh, dropped = migrate(sh, *jc, dom)
                assert int(dropped) == 0
                if int(misplaced(sh, *jc, dom)) == 0:
                    break
            rec["passes"] = k + 1
        elif op[0] == "refine":
            mr, gdrop = jpen.make_max_run(mesh, spec)(sh, *jc, dom)
            assert int(gdrop) == 0
            spec = jpen.refine_wseg(spec, int(mr))
        rec["cuts"] = (np.asarray(c0), np.asarray(c1))
        rec["rows"] = {k: np.asarray(getattr(sh, k)) for k in sh._fields}
        recs.append(rec)
    return recs


def _close(got, want, what):
    scale = np.abs(want).max() + 1e-300
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale,
                               err_msg=what)


def run_both(cfg, st, dom, grid, ops, plan_kw=None, cuts=None,
             refine=True):
    """``ops`` through the JAX package and the port's ranks from one
    sharded state (``jax_setup``'s); (port records, JAX records, the
    port's ``pencil_lockstep`` arguments before ``ops``)."""
    ns0, ns1 = grid
    mesh, spec, cuts, sh = jax_setup(cfg, st, dom, ns0, ns1, cuts, refine,
                                     **(plan_kw or {}))
    rows0 = {k: np.asarray(getattr(sh, k)) for k in sh._fields}
    tdrive = jdrive = None
    n_driven = sum(op[1] for op in ops if len(op) > 3 and op[0] == "chunk"
                   and op[3])
    if n_driven:
        modes = tuple(map(tuple, driving.make_modes(1, 2).astype(int)))
        jd0 = jdrv.init(jax.random.PRNGKey(5), modes, jnp.float64)
        tdrive = (driving.DriveSpec(modes=modes, tau=0.5, accel_rms=0.5),
                  np.asarray(jd0.amp_re), np.asarray(jd0.amp_im),
                  _jax_noise(jd0.key, len(modes), n_driven))
        jdrive = (JDriveSpec(modes=modes, tau=0.5, accel_rms=0.5), jd0)
    want = jax_ops(sh, mesh, cfg, spec, cuts, dom, ops, drive=jdrive)
    args = (rows0, (np.asarray(dom.lo), np.asarray(dom.hi), dom.periodic),
            tconf.SPHConfig(**dataclasses.asdict(cfg)),
            convert.pencil_spec_from_fields(**dataclasses.asdict(spec)),
            cuts)
    got = comm.launch(pencil_lockstep, ns0 * ns1, "cpu", "gloo", timeout=60,
                      deadline=240, args=args + (ops, tdrive))
    return got, want, args


def check_records(got, want, what0):
    """After every op: the cuts, histograms, health (zero), builds,
    passes, closings and dt violations equal; the dts, every field of the
    real rows and the layout itself (which rows are real, the padding
    rows' positions, velocities and masses) at 1e-10; the driving
    amplitudes too after a driven chunk."""
    assert [r["op"] for r in got] == [r["op"] for r in want]
    for g, w in zip(got, want):
        what = f"{what0}, after {g['op']}"
        for a, b in zip(g["cuts"], w["cuts"]):
            np.testing.assert_array_equal(a, b, err_msg=what)
        for k in ("health", "builds", "passes", "nacts", "dt_viol"):
            assert np.array_equal(g.get(k), w.get(k)), (what, k, g.get(k),
                                                        w.get(k))
        assert ("hist" in g) == ("hist" in w), what
        for a, b in zip(g.get("hist", ()), w.get("hist", ())):
            np.testing.assert_array_equal(a, b, err_msg=what)
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


LOCKSTEP = {
    # both cut axes and the corner ghosts: a step, a chunk at the reuse
    # cadence, then a driven chunk (the JAX noise draws replayed into the
    # port); the rebalance and migration are tests/test_torch_pencil.py's
    "2x2-fixed_h": ((2, 2), "fixed_h", [("step",), ("chunk", 2, 2),
                                        ("chunk", 2, 1, True)]),
    "2x2-gradh_balsara": ((2, 2), "gradh_balsara", [("step",),
                                                    ("chunk", 2, 2)]),
    # degenerate grids: the ring of one along an axis hands a rank its own
    # messages (its faces are ghosts of itself across the periodic seam)
    "1x2-fixed_h": ((1, 2), "fixed_h", [("step",), ("chunk", 2, 2)]),
    "2x1-gradh_balsara": ((2, 1), "gradh_balsara", [("chunk", 2, 2)]),
}


@pytest.mark.parametrize("case", ["2x2-fixed_h", "1x2-fixed_h"])
def test_pencil_slice_matches_reference(case):
    """The other cases are in tests/test_torch_pencil_lockstep_gradh.py."""
    check_case(case)


def check_case(case):
    """One ``LOCKSTEP`` case from the derived initial state (the JAX
    package's dense engine), checked by ``check_records``."""
    grid, name, ops = LOCKSTEP[case]
    cfg = PENCIL_CONFIGS[name]
    st, dom = _problem(cfg)
    st = jdense.update_derived(st, cfg, dom, block=64)
    got, want, _ = run_both(cfg, st, dom, grid, ops)
    check_records(got, want, case)
