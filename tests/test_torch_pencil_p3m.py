"""P3M self-gravity on the port's pencils against ``sphax.dist.pencil``
(``use_pallas=False``, ``sorted_mesh=False``: the scatter mesh, every
rank's deposit SUM all-reduced over both grid axes, and the screened short
range beside the window walk) on a 2x2 grid at 1e-10: two steps and a
chunk at the reuse cadence, tests/dist/test_pencil.py's P3M configuration
at its size. The port runs the short range in kernel C's fused gravity
mode (its plain version here).
"""
import numpy as np

from sphax import SPHConfig
from sphax.physics import dense as jdense
from tests.dist.test_wslab import _problem
from tests.test_torch_pencil_lockstep import check_records, run_both

P3M = SPHConfig(dim=3, adaptive_h=False, grad_h=False, gravity=True, G=1.3,
                grav_eps=0.004, grav_solver="p3m", grav_mesh=32,
                grav_rs_cells=2.0)


def test_pencil_p3m_matches_reference():
    st, dom = _problem(P3M)
    st = jdense.update_derived(st, P3M, dom, block=64)
    got, want, _ = run_both(P3M, st, dom, (2, 2),
                            [("step",), ("step",), ("chunk", 2, 2)])
    check_records(got, want, "2x2 P3M")
    # gravity pulls: the mesh and the short range both reach the forces
    acc = want[-1]["rows"]["acc"][want[-1]["rows"]["mass"] > 0]
    assert np.isfinite(acc).all() and np.abs(acc).max() > 0
