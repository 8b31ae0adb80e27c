"""The port's engines against ``sphax.reference_cpu``: the 1e-6 gate.

``tests/parity/test_dense_vs_reference.py`` holds the JAX dense engine to the
float64 NumPy reference at 1e-6 on identical initial conditions. This file
is that gate for the port: ``sphax_torch.physics.dense`` and the window
engine's plain path (``wengine.update_derived`` on CPU tensors, which takes
the plain versions of kernels A and C) against the JAX package's reference
itself, on the same seeded problems and configurations, in float64, at the
same tolerance; and the same three KDK steps in lockstep. The reference
shares no code with ``window_kernels._LivePairs``, so it is an independent
ground truth for what the plain versions, and through them the CUDA
kernels, compute. (The port's copy, ``sphax_torch.reference_cpu``, serves
where JAX is absent, and ``test_torch_contract`` holds it equal to the
original bit for bit.) The dense cases run at the reference test's sizes
(6^3, 10^2); the window cases at tests/parity/test_window_vs_dense.py's
(8^3, 12^2), the smallest boxes its planner accepts.
"""
import numpy as np
import pytest
import torch

import sphax
import sphax.reference_cpu as ref
from sphax_torch import SPHConfig, make_state
from sphax_torch import reference_cpu as ref_np
from sphax_torch.core.state import box
from sphax_torch.integrate import leapfrog
from sphax_torch.neighbors import window as win
from sphax_torch.physics import dense, wengine
from tests.parity.test_dense_vs_reference import make_problem

torch.set_num_threads(1)

RTOL = 1e-6  # the gate; the agreement is about 1e-12

# keyword arguments of both packages' SPHConfig
CONFIGS = {
    "fixed_h": dict(dim=3, adaptive_h=False, grad_h=False),
    "adaptive": dict(dim=3, adaptive_h=True, grad_h=False,
                          newton_iters=10),
    "gradh": dict(dim=3, adaptive_h=True, grad_h=True, newton_iters=10),
    "balsara": dict(dim=3, adaptive_h=True, grad_h=True, balsara=True,
                         newton_iters=10),
    "gravity": dict(dim=3, adaptive_h=False, gravity=True, G=2.3,
                         grav_eps=0.05),
    "isothermal": dict(dim=3, isothermal=True, cs_iso=1.7,
                            adaptive_h=True, newton_iters=10),
    "dim2": dict(dim=2, adaptive_h=True, grad_h=True, balsara=True,
                      newton_iters=10),
}
N_SIDE = {"dense": {3: 6, 2: 10}, "window": {3: 8, 2: 12}}


def _engine(which, kw, seed, flow=None, alpha0=1.0):
    """(numpy problem, state, domain, derived function, window spec or
    None) of one of the port's engines under ``SPHConfig(**kw)``;
    ``flow(vel, pos)`` replaces the problem's velocities."""
    cfg = SPHConfig(**kw)
    prob = make_problem(dim=cfg.dim, n_side=N_SIDE[which][cfg.dim], seed=seed)
    if flow is not None:
        pos, vel, mass, u, h = prob
        prob = pos, flow(vel, pos), mass, u, h
    state = make_state(*(torch.as_tensor(a, dtype=torch.float64)
                         for a in prob), alpha0=alpha0)
    dom = box(torch.zeros(cfg.dim, dtype=torch.float64),
              torch.ones(cfg.dim, dtype=torch.float64))
    if which == "dense":
        return prob, state, dom, lambda s: dense.update_derived(
            s, cfg, dom, block=64), None
    spec = win.plan_windows(dom, h_max=float(state.h.max()) * 1.25,
                            n=state.n, dim=cfg.dim)
    assert int(wengine.overflow_count(state, dom, spec)) == 0
    return prob, state, dom, lambda s: wengine.update_derived(
        s, cfg, dom, spec), spec


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("which", ["dense", "window"])
def test_update_derived_parity(which, name):
    kw = CONFIGS[name]
    (pos, vel, mass, u, h), state, _, derived, spec = _engine(which, kw,
                                                              seed=3)
    der = ref.update_derived(pos, vel, mass, u, h, sphax.SPHConfig(**kw),
                             box=np.ones(kw["dim"]))
    out = derived(state)
    if spec is not None:  # no h pinned at the structure's cap
        assert int(wengine.capped_count(out, spec)) == 0
    for k in ("h", "rho", "P", "omega"):
        np.testing.assert_allclose(getattr(out, k).numpy(), der[k],
                                   rtol=RTOL, err_msg=k)
    scale = np.max(np.abs(der["acc"]))
    np.testing.assert_allclose(out.acc.numpy(), der["acc"], rtol=RTOL,
                               atol=RTOL * scale)
    uscale = np.max(np.abs(der["du_dt"])) + 1e-30
    np.testing.assert_allclose(out.du_dt.numpy(), der["du_dt"], rtol=RTOL,
                               atol=RTOL * uscale)


@pytest.mark.parametrize("which", ["dense", "window"])
def test_kdk_step_parity(which):
    """Three full KDK steps stay in lockstep with the reference."""
    kw = dict(dim=3, adaptive_h=True, grad_h=True, newton_iters=10)
    cfg, cfg_ref = SPHConfig(**kw), sphax.SPHConfig(**kw)
    (pos, vel, mass, u, h), state, dom, derived, _ = _engine(which, kw,
                                                             seed=7)
    box_arr = np.ones(3)
    der = ref.update_derived(pos, vel, mass, u, h, cfg_ref, box=box_arr)
    state = derived(state)
    p, v, uu, hh = pos, vel, u, h
    for _ in range(3):
        p, v, uu, hh, der, dt_ref = ref.step(p, v, mass, uu, hh, der,
                                             cfg_ref, box=box_arr)
        state, dt = leapfrog.step(state, cfg, dom, derived)
        assert abs(float(dt) - dt_ref) < 1e-9 * dt_ref
    np.testing.assert_allclose(state.pos.numpy(), p, rtol=RTOL, atol=1e-9)
    np.testing.assert_allclose(state.vel.numpy(), v, rtol=RTOL,
                               atol=RTOL * np.max(np.abs(v)))
    np.testing.assert_allclose(state.u.numpy(), uu, rtol=RTOL)
    np.testing.assert_allclose(state.rho.numpy(), der["rho"], rtol=RTOL)


@pytest.mark.parametrize("which", ["dense", "window"])
def test_mm_viscosity_lockstep(which):
    """tests/parity/test_dense_vs_reference.py::test_mm_viscosity_lockstep
    on the port against its own copy of the reference
    (``sphax_torch.reference_cpu``): a convergent flow (div v < 0) raises
    the Morris-Monaghan alpha from its floor, and alpha, rho and acc stay at
    1e-6 of the reference, dt at 1e-12, through 4 KDK steps. Dense at the
    test's 6^3, the window engine's plain path at 8^3."""
    kw = dict(dim=3, adaptive_h=True, newton_iters=25, mm_visc=True,
              alpha_visc=1.0, beta_visc=2.0)
    cfg = SPHConfig(**kw)
    (pos, vel, mass, u, h), state, dom, derived, _ = _engine(
        which, kw, seed=9, flow=lambda v, p: v * 0.1 - 0.6 * (p - 0.5),
        alpha0=cfg.mm_alpha_min)
    box_arr = np.ones(3)
    a_np = np.full(len(pos), cfg.mm_alpha_min)
    der = ref_np.update_derived(pos, vel, mass, u, h, cfg, box=box_arr,
                                alpha=a_np)
    rp, rv, ru, rh = pos, vel, u, h
    state = derived(state)
    for k in range(4):
        rp, rv, ru, rh, der, rdt = ref_np.step(rp, rv, mass, ru, rh, der,
                                               cfg, box=box_arr, alpha=a_np)
        a_np = der["alpha"]
        state, dt = leapfrog.step(state, cfg, dom, derived)
        np.testing.assert_allclose(float(dt), rdt, rtol=1e-12)
        np.testing.assert_allclose(state.alpha.numpy(), a_np, rtol=RTOL,
                                   err_msg=f"alpha step {k}")
        np.testing.assert_allclose(state.rho.numpy(), der["rho"], rtol=RTOL)
        scale = np.max(np.abs(der["acc"]))
        np.testing.assert_allclose(state.acc.numpy(), der["acc"], rtol=RTOL,
                                   atol=RTOL * scale)
    # the switch switched on somewhere
    assert float(state.alpha.max()) > 2.0 * cfg.mm_alpha_min
