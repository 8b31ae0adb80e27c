"""The port's pencil decomposition against the port's own single-device
window engine (tests/dist/test_pencil.py, ported): 3 distributed steps and
a 4-step chunk with structure reuse on a 2x2 grid at that test's 1e-8
(dts 1e-10), and P3M on pencils against the single-device P3M at its 1e-3
(test_pencil.py:145-149), on gloo ranks over CPU tensors (the grad-h step
and the chunk are in tests/test_torch_pencil_single_reuse.py). The reference
rebuilds its structure every step (``tests/test_torch_wslab_lockstep.py``
says why that is the same physics).
"""
import numpy as np
import pytest
import torch

from sphax_torch import configs as tconf
from sphax_torch import convert
from sphax_torch.dist import comm
from sphax_torch.dist import pencil as tpen
from tests._slab_helpers import pencil_lockstep
from tests.test_torch_wslab_lockstep import (_compare, _lattice, _real,
                                             _single)
from tests.test_torch_wslab_migrate import _cloud

torch.set_num_threads(1)

CFGS = {
    "fixed_h": tconf.SPHConfig(dim=3, adaptive_h=False, grad_h=False),
    "gradh_balsara": tconf.SPHConfig(dim=3, adaptive_h=True, grad_h=True,
                                     balsara=True, newton_iters=8),
    "isothermal": tconf.SPHConfig(dim=3, isothermal=True, cs_iso=1.5,
                                  adaptive_h=True, newton_iters=8),
}


def _pencils(st0, cfg, dom, grid, ops):
    """``pencil_lockstep``'s records of ``ops`` on ``grid`` from the
    equal-cut distribution of ``st0`` (wseg refined to the measured run)."""
    spec = tpen.plan(dom, st0.n, float(st0.h.max()) * 1.1, *grid)
    cuts = (tpen.equal_cuts(spec.ncell0, grid[0]),
            tpen.equal_cuts(spec.ncell1, grid[1]))
    shards = [convert.state_to_numpy(tpen.distribute(st0, dom, spec, *cuts,
                                                     r))
              for r in range(grid[0] * grid[1])]
    rows = {k: np.concatenate([s[k] for s in shards]) for k in shards[0]}
    recs = comm.launch(pencil_lockstep, grid[0] * grid[1], "cpu", "gloo",
                       timeout=60, deadline=300,
                       args=(rows, (dom.lo.numpy(), dom.hi.numpy(),
                                    dom.periodic), cfg, spec, cuts, ops,
                             None, True))
    for r in recs:
        if "health" in r:
            assert not np.any(r["health"]), (r["op"], r["health"])
    return recs


@pytest.mark.parametrize("name", ["fixed_h"])
def test_pencil_step_matches_single_device(name):
    """The gradh_balsara case and the chunk are in
    tests/test_torch_pencil_single_reuse.py."""
    check_steps(name)


def check_steps(name):
    """3 steps on 2x2 against 3 single-device steps."""
    cfg = CFGS[name]
    st, dom = _lattice()
    st0, ref, ref_dts = _single(st, cfg, dom, 3)
    recs = _pencils(st0, cfg, dom, (2, 2), [("step",)] * 3)
    np.testing.assert_allclose([r["dts"][0] for r in recs], ref_dts,
                               rtol=1e-10)
    _compare(_real(recs[-1]), ref, dom, ("vel", "u", "h", "rho", "P", "acc"),
             1e-8)


def test_pencil_p3m_matches_single_device():
    """P3M on pencils (the grid's SUM all-reduce over both axes, the
    screened short range in kernel C's gravity mode) against the
    single-device P3M, 2 steps, open box."""
    cfg = tconf.SPHConfig(dim=3, adaptive_h=False, grad_h=False,
                          gravity=True, G=1.3, grav_eps=0.004,
                          grav_solver="p3m", grav_mesh=64,
                          grav_rs_cells=2.0)
    st, dom = _cloud(13)
    st0, ref, _ = _single(st, cfg, dom, 2)
    recs = _pencils(st0, cfg, dom, (2, 2), [("step",)] * 2)
    _compare(_real(recs[-1]), ref, dom, ("vel", "rho", "acc"), 1e-3)
