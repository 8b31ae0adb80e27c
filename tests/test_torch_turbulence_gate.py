"""The twin of ``tests/problems/test_turbulence.py``: OU-driven isothermal
turbulence on the turbulence lattice at 10^3 (``configs.TURB``, float64,
the CPU) stirs the box (Mach in (0.05, 10)) with little net momentum
(< 0.2 of max|v| sum m), and P = cs^2 rho at 1e-12.

The JAX test runs the cell-list engine, which the port does not carry;
the port runs dense, which ``tests/parity/test_clist_vs_dense.py`` holds
equal to it. The noise is a seeded ``torch.Generator``, not threefry, so
the trajectory differs; the bounds are statistical and stay as they are.
"""
import numpy as np
import torch

from sphax_torch import configs
from sphax_torch.core.state import box, make_state
from sphax_torch.diag import conservation
from sphax_torch.ics import turbulence
from sphax_torch.physics import dense, driving
from sphax_torch.run import simulate_until

torch.set_num_threads(1)
F64 = torch.float64


def test_driven_turbulence():
    ic = turbulence.build(n_side=10)
    cfg = configs.TURB
    dom = box(torch.zeros(3, dtype=F64), torch.as_tensor(ic["box"],
                                                         dtype=F64))
    st = make_state(*(torch.as_tensor(ic[k], dtype=F64)
                      for k in ("pos", "vel", "mass", "u", "h")))
    engine = lambda s: dense.update_derived(s, cfg, dom)
    st = engine(st)

    modes = tuple(map(tuple, driving.make_modes(1, 2).astype(int)))
    spec = driving.DriveSpec(modes=modes, tau=0.5, accel_rms=2.0,
                             box_size=1.0)
    noise = driving.gaussian_noise(torch.Generator().manual_seed(3))
    st, _, t, _ = simulate_until(st, cfg, dom, engine, t_end=0.18, chunk=16,
                                 drive=driving.init(len(modes), dtype=F64),
                                 drive_spec=spec, max_steps=1000,
                                 noise=noise)

    rec = conservation.summary(st, cfg, t)
    assert rec["finite"]
    # the driving stirs the box
    assert 0.05 < rec["mach_rms"] < 10.0, rec
    # solenoidal large-scale forcing adds little net momentum; the exact
    # SPH pair forces add none
    ptot = np.sqrt(rec["px"] ** 2 + rec["py"] ** 2 + rec["pz"] ** 2)
    assert ptot < 0.2 * rec["max_v"] * float(st.mass.sum())
    # isothermal: pressure tracks density exactly
    np.testing.assert_allclose(st.P.numpy(), cfg.cs_iso ** 2 * st.rho.numpy(),
                               rtol=1e-12)
