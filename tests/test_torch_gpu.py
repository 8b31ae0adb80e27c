"""The CUDA kernels A and C against their plain torch versions, on a card.

These tests import no JAX (the machine with the card has none) and skip
where no CUDA device is visible. Run them on the card without the suite's
JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -q

Rows that are not particles (ghost images, padding) are don't-care by
contract, so every comparison is on ``is_real`` rows. Tolerances: fp32
3e-5 (rtol, and atol 3e-5 of the largest value: the sums are taken in
another order), fp64 1e-10, and 2e-3 for fp32 ``fast_math`` against the
exact plain version.
"""
import dataclasses

import pytest
import torch

from sphax_torch import configs, make_state
from sphax_torch.core.state import box
from sphax_torch.ics import turbulence
from sphax_torch.neighbors import window as win
from sphax_torch.physics import wengine
from sphax_torch.physics import window_kernels as wk

TOL = {torch.float32: 3e-5, torch.float64: 1e-10}
A_CASES = {
    "cold_newton2": dataclasses.replace(configs.TURB, newton_iters=2),
    "h_predict": dataclasses.replace(configs.TURB, newton_iters=1,
                                     h_predict=True),
    "balsara_off": configs.SPHConfig(dim=3, adaptive_h=True, newton_iters=2),
}
KNOBS = dict(cutoff_scale=1.05, ghost_safety=1.4, fast_sub=3, rgroups=2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(device, dtype, n_side=16, seed=0):
    """Sorted inputs at the production window geometry, owner-consistent on
    ghost rows, from the turbulence ICs and a seeded generator."""
    ic = turbulence.build(n_side=n_side)
    st = make_state(*(torch.as_tensor(ic[k], dtype=dtype, device=device)
                      for k in ("pos", "vel", "mass", "u", "h")))
    dom = box(torch.zeros(3, dtype=dtype, device=device),
              torch.ones(3, dtype=dtype, device=device))
    spec = win.plan_measured(st.pos, dom, h_max=float(st.h.max()) * 1.05,
                             dim=3, **KNOBS)
    wd = win.build(st.pos, dom, spec)
    g = torch.Generator(device=device).manual_seed(seed)

    def rnd(lo, hi):
        return lo + (hi - lo) * torch.rand(st.n, generator=g, dtype=dtype,
                                           device=device)
    vel = 0.4 * torch.randn(st.vel.shape, generator=g, dtype=dtype,
                            device=device)
    rho = rnd(0.8, 1.2)
    cols = dict(vel_s=(vel, 0.0), mass_s=(st.mass, 0.0), h0_s=(st.h, 1.0),
                h_s=(st.h * rnd(0.95, 1.05), 1.0), rho_s=(rho, 1.0),
                P_s=(rho * rnd(0.9, 1.1), 1.0), cs_s=(rnd(0.8, 1.2), 1.0),
                om_s=(rnd(0.9, 1.1), 1.0), bf_s=(rnd(0.0, 1.0), 0.0))
    f = {k: win.gather_sorted(v, wd, fill) for k, (v, fill) in cols.items()}
    f["pos_s"] = wd.pos_s
    return st, dom, spec, wd, f


def _compare(got, want, real, tol, what):
    got, want = got[real].double().cpu(), want[real].double().cpu()
    assert bool(torch.isfinite(got).all()), what
    torch.testing.assert_close(got, want, rtol=tol,
                               atol=tol * float(want.abs().max()), msg=what)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", sorted(A_CASES))
def test_solve_h_density_kernel_matches_plain(cuda, dtype, case):
    cfg = A_CASES[case]
    _, _, spec, wd, f = _inputs(cuda, dtype)
    vel = f["vel_s"] if cfg.need_divv else None
    args = (f["pos_s"], f["mass_s"], f["h0_s"])
    n0 = wk.LAUNCHES["solve_h_density"]
    got = wk.solve_h_density(wd, spec, *args, cfg, vel_s=vel)
    torch.cuda.synchronize()
    assert wk.LAUNCHES["solve_h_density"] == n0 + 1
    want = wk.solve_h_density_plain(wd, spec, *args, cfg, vel_s=vel)
    assert len(got) == len(want) == (5 if cfg.need_divv else 3)
    for k, (a, b) in enumerate(zip(got, want)):
        _compare(a, b, wd.is_real, TOL[dtype], f"{case} output {k}")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,fast", [(torch.float32, False),
                                        (torch.float64, False),
                                        (torch.float32, True)])
@pytest.mark.parametrize("balsara", [True, False])
def test_forces_kernel_matches_plain(cuda, dtype, fast, balsara):
    cfg = dataclasses.replace(configs.TURB, balsara=balsara, fast_math=fast)
    _, _, spec, wd, f = _inputs(cuda, dtype, seed=1)
    args = [f[k] for k in ("pos_s", "vel_s", "mass_s", "h_s", "rho_s", "P_s",
                           "cs_s", "om_s", "bf_s")]
    n0 = wk.LAUNCHES["forces"]
    got = wk.forces(wd, spec, *args, cfg)
    torch.cuda.synchronize()
    assert wk.LAUNCHES["forces"] == n0 + 1
    want = wk.forces_plain(wd, spec, *args, cfg)
    tol = 2e-3 if fast else TOL[dtype]
    _compare(got[0], want[0], wd.is_real, tol, "acc")
    _compare(got[1], want[1], wd.is_real, tol, "du")


@pytest.mark.gpu
def test_cuda_tensor_never_runs_the_plain_version(cuda, monkeypatch):
    """A derived pass on the card launches each kernel once and calls no
    plain version."""
    def refuse(*a, **k):
        raise AssertionError("plain version called on a CUDA tensor")

    monkeypatch.setattr(wk, "solve_h_density_plain", refuse)
    monkeypatch.setattr(wk, "forces_plain", refuse)
    cfg = dataclasses.replace(configs.TURB, newton_iters=1)
    st, dom, spec, _, _ = _inputs(cuda, torch.float32)
    n0 = dict(wk.LAUNCHES)
    out = wengine.update_derived(st, cfg, dom, spec)
    torch.cuda.synchronize()
    assert {k: wk.LAUNCHES[k] - n0[k] for k in n0} == {k: 1 for k in n0}
    assert bool(torch.isfinite(out.acc).all())
