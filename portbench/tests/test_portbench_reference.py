"""The reference against brute force and against the port's plain path.

The reference imports nothing of the program; here, on the CPU in float64,
it is held to the port's dense engine (exact all-pairs sums) at 8^3, which
is how the benchmark knows its equations are the configurations' own.
"""
import math

import numpy as np
import pytest
import torch

from portbench import ics as ICS
from portbench import reference as R
from portbench import spec, yardstick

F64 = torch.float64


def _brute(pos, h):
    d = pos[:, None, :] - pos[None, :, :]
    d = d - torch.round(d)
    r = torch.sqrt((d * d).sum(-1))
    a = int((r < 2 * h[:, None]).sum())
    c = int(((r < 2 * torch.maximum(h[:, None], h[None, :])) & (r > 0)).sum())
    return a, c


def test_pair_counter_against_brute_force():
    g = torch.Generator().manual_seed(3)
    pos = torch.rand(500, 3, generator=g, dtype=F64)
    h = 0.02 + 0.04 * torch.rand(500, generator=g, dtype=F64)
    assert yardstick.pair_counts(pos, h, block=64) == _brute(pos, h)
    # a grid of 3 cells a side, and the all-pairs fallback below it
    wide = h * 2.5
    assert yardstick.pair_counts(pos, wide, block=64) == _brute(pos, wide)
    assert yardstick.pair_counts(pos, h * 4, block=64) == _brute(pos, h * 4)


def _problem(name, n):
    from sphax_torch import problems

    cfg_file = spec.load("configs", name)
    ic = dict(cfg_file["ics"], n_side=n)
    made = ICS.make(ic, 11, F64, "cpu")
    sph = cfg_file["sph"]
    from sphax_torch.configs import SPHConfig
    from sphax_torch.core.state import box, make_state

    cfg = SPHConfig(**sph)
    st = make_state(made["pos"], made["vel"], made["mass"], made["u"],
                    made["h"])
    dom = box(torch.zeros(3, dtype=F64), torch.ones(3, dtype=F64))
    w = cfg_file["window"]
    hcap = w["cutoff_scale"] * w["h_margin"] * ic["eta"] / n
    del problems
    return cfg, st, dom, made, sph, hcap


@pytest.mark.parametrize("name", ["turb-bs12-256", "sedov-128"])
def test_derived_pass_matches_the_dense_engine(name):
    from sphax_torch.physics import dense

    cfg, st, dom, made, sph, hcap = _problem(name, 8)
    want = dense.update_derived(st, cfg, dom)
    rows = torch.arange(st.n)
    got = R.derived_start(R.Arith(), made, rows, sph, hcap, 1.0)
    for k, kw in (("h", "h"), ("rho", "rho"), ("divv", "divv"),
                  ("acc", "acc"), ("du_dt", "du_dt"), ("omega", "omega")):
        a, b = got[k], getattr(want, kw)
        scale = float(b.abs().max()) or 1.0
        assert float((a - b).abs().max()) <= 1e-10 * scale, k


@pytest.mark.parametrize("name", ["turb-bs12-256", "sedov-128"])
def test_kdk_step_matches_the_port(name):
    from sphax_torch.integrate import leapfrog
    from sphax_torch.physics import dense

    cfg, st, dom, made, sph, hcap = _problem(name, 8)
    st = dense.update_derived(st, cfg, dom)
    want, dt = leapfrog.step(st, cfg, dom,
                             lambda s: dense.update_derived(s, cfg, dom))
    rows = torch.arange(st.n)
    got = R.kdk_step(R.Arith(), st._asdict(), rows, sph, hcap, 1.0)
    assert float(got["dt"]) == pytest.approx(float(dt), rel=1e-12)
    for k in ("pos", "vel", "u", "h", "rho", "acc", "du_dt", "divv"):
        a, b = got[k], getattr(want, k)
        scale = float(b.abs().max()) or 1.0
        assert float((a - b).abs().max()) <= 1e-10 * scale, k


def test_driving_matches_the_port():
    from sphax_torch.physics import driving

    d = spec.load("configs", "turb-bs12-256")["drive"]
    modes = R.drive_modes(d["kmin"], d["kmax"], "cpu")
    want_modes = driving.make_modes(d["kmin"], d["kmax"])
    assert np.array_equal(modes.numpy(), want_modes)
    g = torch.Generator().manual_seed(5)
    st = driving.init(len(modes), dtype=F64)
    re, im = st.amp_re, st.amp_im
    pos = torch.rand(64, 3, generator=g, dtype=F64)
    for dt in (1e-3, 4e-4, 2e-3):
        xi = tuple(torch.randn(re.shape, generator=g, dtype=F64)
                   for _ in range(2))
        st = driving.update(st, modes, torch.tensor(dt, dtype=F64), d["tau"],
                            d["accel_rms"], d["box"], noise=xi)
        re, im = R.ou_update(re, im, modes, dt, d, *xi)
    assert torch.allclose(re, st.amp_re, rtol=0, atol=1e-13)
    assert torch.allclose(im, st.amp_im, rtol=0, atol=1e-13)
    a = R.drive_accel(R.Arith(), pos, re, im, modes, d)
    assert torch.allclose(a, driving.acceleration(pos, st, modes, d["box"]),
                          rtol=0, atol=1e-12)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10, 3.14159265],
                     dtype=torch.float32)
    y = R.tf32(x)
    assert y[0] == 1.0 and y[2] == 1.0 + 2**-10
    assert y[1] == 1.0 + 2**-10          # a tie rounds away from zero
    assert abs(float(y[3]) - math.pi) <= 2**-11 * math.pi
    bits = y.view(torch.int32) & 0x1FFF
    assert int(bits.abs().sum()) == 0
