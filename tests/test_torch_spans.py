"""The program's spans (``io.metrics.span``): none is entered while no
profiler records, and under a profiler the loops of ``wengine.simulate``
and ``rungs.simulate_rungs`` emit one span per step or tick, build,
derived pass and kernel wrapper, nested as ``io.metrics`` documents."""
import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sphax_torch import configs, make_state
from sphax_torch.core.state import box
from sphax_torch.ics import sedov, turbulence
from sphax_torch.integrate import rungs
from sphax_torch.io import metrics
from sphax_torch.neighbors import window as win
from sphax_torch.physics import driving, wengine

torch.set_num_threads(1)

STEPS = 4
SPANS_PER_CHUNK = 2       # rung spans of 4 ticks (3 rungs)


def _problem(kind):
    """A small box on the window engine's plain path: driven turbulence
    (12^3, the ``turb`` configuration) or a Sedov blast (10^3, ``sedov``),
    with its derived pass run."""
    if kind == "turb":
        ic, cfg = turbulence.build(n_side=12), configs.TURB
        ic["vel"] = 0.1 * np.random.default_rng(0).standard_normal(
            ic["pos"].shape)
    else:
        ic, cfg = sedov.build(n_side=10, E=1.0), configs.SEDOV
    cfg = dataclasses.replace(cfg, newton_iters=2)
    st = make_state(*(torch.as_tensor(ic[k]) for k in
                      ("pos", "vel", "mass", "u", "h")))
    dom = box(torch.zeros(3, dtype=torch.float64), torch.as_tensor(ic["box"]))
    spec = win.plan_measured(st.pos, dom, h_max=float(st.h.max()) * 1.3,
                             dim=3, cutoff_scale=1.25)
    return wengine.update_derived(st, cfg, dom, spec), cfg, dom, spec


def _chunk(case, problem):
    """Run one chunk of ``case`` from ``problem``; returns the counts its
    loop reports: steps or ticks, builds, derived passes (each with kernels
    A and C), and seeding passes (kernel A only)."""
    loop, adaptive = case.split("-")
    adaptive = 2 if adaptive == "adaptive" else 0
    st, cfg, dom, spec = problem
    if loop == "global":
        modes = tuple(map(tuple, driving.make_modes(1, 2).astype(int)))
        dspec = driving.DriveSpec(modes=modes, tau=0.5, accel_rms=0.5)
        gen = torch.Generator().manual_seed(3)
        out = wengine.simulate(
            st, cfg, dom, spec, STEPS, drive=driving.init(len(modes)),
            drive_spec=dspec, noise=driving.gaussian_noise(gen),
            adaptive_rebuild=adaptive)
        builds = out[4] if adaptive else STEPS // 2
        return dict(steps=STEPS, builds=builds, derived=STEPS, seeding=0)
    out = rungs.simulate_rungs(st, cfg, dom, spec, SPANS_PER_CHUNK,
                               n_rungs=3, adaptive_rebuild=adaptive)
    ticks = len(out[1])
    # the seeding pass builds its own structure and runs kernel A once
    return dict(steps=ticks, builds=out[5] + 1, derived=ticks, seeding=1)


CASES = ["global-fixed", "global-adaptive", "rungs-fixed", "rungs-adaptive"]


@pytest.fixture(scope="module")
def problems():
    return {"global": _problem("turb"), "rungs": _problem("sedov")}


def _problem_of(case, problems):
    return problems[case.split("-")[0]]


@pytest.mark.parametrize("case", CASES)
def test_no_span_is_entered_without_a_profiler(monkeypatch, problems,
                                               case):
    def refuse(name, *args, **kwargs):
        raise AssertionError(f"record_function({name!r}) entered with no "
                             "profiler recording")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    _chunk(case, _problem_of(case, problems))


@pytest.mark.parametrize("case", CASES)
def test_spans_count_the_loops_work(problems, case):
    problem = _problem_of(case, problems)
    builds0 = win.BUILDS["n"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        want = _chunk(case, problem)
    spans = [(e.name, e.time_range.start, e.time_range.end)
             for e in prof.events() if e.name.startswith("sphax_torch.")]
    assert {name for name, _, _ in spans} <= set(metrics.SPANS)
    count = {name: sum(1 for n, _, _ in spans if n == name)
             for name in metrics.SPANS}
    step = "sphax_torch.step" if case.startswith("global") else \
        "sphax_torch.tick"
    other = ({"sphax_torch.step", "sphax_torch.tick"} - {step}).pop()
    assert count[step] == want["steps"] and count[other] == 0
    assert count["sphax_torch.build"] == want["builds"] == \
        win.BUILDS["n"] - builds0
    derived = want["derived"] + want["seeding"]
    assert count["sphax_torch.derived"] == derived
    assert count["sphax_torch.kernel_a"] == derived
    assert count["sphax_torch.kernel_c"] == want["derived"]
    outer = [(a, b) for n, a, b in spans if n == "sphax_torch.derived"]
    for name, a, b in spans:
        if name in ("sphax_torch.kernel_a", "sphax_torch.kernel_c"):
            assert any(a0 <= a and b <= b0 for a0, b0 in outer), name
