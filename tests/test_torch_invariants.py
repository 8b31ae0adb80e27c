"""The JAX package's invariant gates on the port's dense engine, and its
open-boundary gate on the port's window engine, with the JAX tests' seeds,
sizes and bounds (float64 inputs made with numpy):

- ``tests/unit/test_conservation.py``: the symmetrised SPH forms conserve
  momentum and (at fixed h) energy exactly, and energy to the Newton
  residual with grad-h terms;
- ``tests/unit/test_properties.py``: the same invariants over random
  states, dims and configurations with unequal masses; the pair force's
  antisymmetry (``pairs.force_terms``, rtol 1e-12); the kernel positive and
  monotone; density and h positive with the h-rho relation at 1e-6;
- ``tests/parity/test_window_vs_dense.py::test_open_boundary``: no ghosts
  on an open box, the structurally capped h confined to the edge layer and
  under 35 %, rho at 1e-10 of the dense engine off it.
"""
import numpy as np
import pytest
import torch

from sphax_torch import SPHConfig, make_state
from sphax_torch.core.state import box
from sphax_torch.neighbors import window as win
from sphax_torch.physics import dense, pairs, wengine
from sphax_torch.physics import kernels as K
from tests._torch_helpers import make_problem

torch.set_num_threads(1)
F64 = torch.float64


def _t(a):
    return torch.as_tensor(a, dtype=F64)


def _unit_box(dim, periodic=True):
    return box(torch.zeros(dim, dtype=F64), torch.ones(dim, dtype=F64),
               periodic=periodic)


def _derived(cfg, seed=11):
    """test_conservation.py's state through the dense engine."""
    prob = make_problem(dim=cfg.dim, n_side=6, seed=seed)
    st = make_state(*map(_t, prob))
    return dense.update_derived(st, cfg, _unit_box(cfg.dim), block=64)


def _rates(st):
    """(dP/dt [dim], its scale max|m a|, dE/dt, its scale sum m|du/dt|)."""
    ma = st.mass[:, None] * st.acc
    dE = float(torch.sum(st.mass * (torch.sum(st.vel * st.acc, -1)
                                    + st.du_dt)))
    return (ma.sum(0).numpy(), float(ma.abs().max()), dE,
            float(torch.sum(st.mass * st.du_dt.abs())))


def test_momentum_rate_is_zero():
    st = _derived(SPHConfig(dim=3, adaptive_h=False))
    dp, scale, _, _ = _rates(st)
    assert np.all(np.abs(dp) < 1e-11 * scale * st.n)


def test_energy_rate_is_zero_fixed_h():
    st = _derived(SPHConfig(dim=3, adaptive_h=False))
    _, _, dE, scale = _rates(st)
    assert abs(dE) < 1e-10 * (scale + 1e-30) * st.n


def test_energy_rate_small_adaptive_gradh():
    """With converged h and Omega terms the energy error is the Newton
    residual's size."""
    st = _derived(SPHConfig(dim=3, adaptive_h=True, grad_h=True,
                            newton_iters=30))
    _, _, dE, scale = _rates(st)
    assert abs(dE) < 1e-8 * (scale + 1e-30) * st.n


@pytest.mark.parametrize("seed", range(5))
def test_momentum_energy_invariants_random(seed):
    """Exact pairwise antisymmetry: dP/dt = 0 and dE/dt = 0 at fixed h,
    over random states, dims and configurations with unequal masses."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(40, 200))
    dim = int(rng.integers(2, 4))
    pos = rng.random((n, dim))
    vel = rng.standard_normal((n, dim))
    mass = rng.random(n) + 0.1
    u = rng.random(n) + 0.5
    h = np.full(n, 1.5 * n ** (-1.0 / dim))
    cfg = SPHConfig(dim=dim, adaptive_h=False,
                    gamma=float(rng.uniform(1.2, 2.0)),
                    alpha_visc=float(rng.uniform(0.5, 2.0)),
                    beta_visc=float(rng.uniform(1.0, 4.0)))
    st = make_state(*map(_t, (pos, vel, mass, u, h)))
    st = dense.update_derived(st, cfg, _unit_box(dim), block=64)
    dp, pscale, dE, escale = _rates(st)
    assert np.all(np.abs(dp) < 1e-10 * (pscale + 1e-300) * n)
    assert abs(dE) < 1e-9 * (escale + 1e-300) * n


@pytest.mark.parametrize("seed", range(3))
def test_pair_force_antisymmetry(seed):
    """fcoef = m_j S(i, j) with S symmetric under i <-> j, so a pair's
    momentum contributions cancel."""
    rng = np.random.default_rng(100 + seed)
    cfg = SPHConfig(dim=3, adaptive_h=False)
    dx = _t(rng.standard_normal(3) * 0.1)
    r = torch.sqrt(torch.sum(dx * dx))
    dv = _t(rng.standard_normal(3))
    h1, h2, rho1, rho2, P1, P2 = map(_t, (0.2, 0.3, 1.1, 0.7, 2.0, 0.5))
    one = _t(1.0)
    f12, _ = pairs.force_terms(dx, r, dv, h1, h2, rho1, rho2, P1, P2,
                               _t(1.3), _t(0.9), one, one, _t(3.0), cfg)
    f21, _ = pairs.force_terms(-dx, r, -dv, h2, h1, rho2, rho1, P2, P1,
                               _t(0.9), _t(1.3), one, one, _t(2.0), cfg)
    np.testing.assert_allclose(float(f12) / 3.0, float(f21) / 2.0,
                               rtol=1e-12)


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_kernel_positive_and_monotone(dim):
    """W >= 0 everywhere and non-increasing in r."""
    h = 0.7
    w = K.W(_t(np.linspace(0, 2.5 * h, 400)), h, dim).numpy()
    assert np.all(w >= 0)
    assert np.all(np.diff(w) <= 1e-12)


@pytest.mark.parametrize("seed", range(3))
def test_density_positive_random(seed):
    rng = np.random.default_rng(200 + seed)
    n = 128
    cfg = SPHConfig(dim=3, adaptive_h=True, newton_iters=15)
    st = make_state(_t(rng.random((n, 3))), torch.zeros((n, 3), dtype=F64),
                    torch.full((n,), 1.0 / n, dtype=F64),
                    torch.ones(n, dtype=F64), torch.full((n,), 0.3,
                                                         dtype=F64))
    st = dense.update_derived(st, cfg, _unit_box(3), block=64)
    assert float(st.rho.min()) > 0
    assert float(st.h.min()) > 0
    # adaptive h satisfies the consistency relation to Newton tolerance
    np.testing.assert_allclose(
        st.rho.numpy(), (st.mass * (cfg.eta / st.h) ** 3).numpy(),
        rtol=1e-6)


def test_open_boundary():
    """A non-periodic box: the window engine's plain path makes no images,
    and agrees with the dense engine exactly wherever the structure covers
    the adaptive h. At the open corners the Newton h wants more than the
    structural cap (h <= cutoff / 2), so the capped rows must lie in the
    boundary layer."""
    cfg = SPHConfig(dim=3, adaptive_h=True, newton_iters=20)
    pos, vel, mass, u, h = make_problem(dim=3, n_side=8, seed=3)
    st = make_state(*map(_t, (pos, vel, mass, u, h)))
    dom = _unit_box(3, periodic=False)
    spec = win.plan_windows(dom, h_max=float(st.h.max()) * 1.25, n=st.n,
                            dim=3)
    assert sum(spec.ghost_caps) == 0
    assert int(wengine.overflow_count(st, dom, spec)) == 0
    a = dense.update_derived(st, cfg, dom, block=64)
    b = wengine.update_derived(st, cfg, dom, spec)

    capped = b.h.numpy() >= 0.5 * spec.cutoff * (1 - 1e-6)
    edge_layer = np.any((pos < 0.25) | (pos > 0.75), axis=-1)
    assert capped.mean() < 0.35
    assert np.all(edge_layer[capped]), "capping must be a boundary effect"
    np.testing.assert_allclose(b.rho.numpy()[~capped], a.rho.numpy()[~capped],
                               rtol=1e-10)
    np.testing.assert_allclose(b.rho.numpy()[~edge_layer],
                               a.rho.numpy()[~edge_layer], rtol=1e-10)
