"""A whole run on the CPU at a small size, past the harness's look for a
card: sound runs come out correct; the control (the reference in TF32 in
the program's place) and runs with the timed path broken do not."""
import pytest
import torch

from portbench import run, spec

SMALL = {"turb256.fixed": dict(n=12, chunk=2, episode_chunks=2),
         "turb256.gated": dict(n=12, chunk=2, episode_chunks=2),
         "sedov128.global": dict(n=16, chunk=2, episode_chunks=2),
         "sedov128.rungs3": dict(n=16, chunk=8, episode_chunks=2)}


@pytest.fixture(autouse=True)
def window_engine_on_cpu(monkeypatch):
    """The problems take the window engine on a card; on the CPU the
    registry would take the dense engine or the cell list, so the tests
    take the window engine's plain versions as the card's path."""
    from sphax_torch import problems

    def auto(st, cfg, dom, h_margin=1.3, cutoff_scale=1.25):
        eng, sp = problems._window_engine(st, cfg, dom, h_margin,
                                          cutoff_scale)
        return eng, sp, "window"
    monkeypatch.setattr(problems, "_auto_engine", auto)


def _run(name, seed=2**31 + 7, control=False, trace=0):
    res, lines = run.execute(spec.cell(name), seed, 0.01, trace,
                             torch.device("cpu"), override=SMALL[name],
                             control=control)
    assert lines[-1].startswith(list(res["compared"])[-1])
    return res


@pytest.mark.parametrize("name", sorted(SMALL))
def test_sound_run_is_correct(name):
    res = _run(name)
    assert res["correct"], res["compared"]
    assert list(res)[-1] == "compared"


@pytest.mark.parametrize("name", sorted(SMALL))
def test_the_control_in_the_programs_place_is_not_correct(name):
    """``--control 1``: the control's readings decide ``correct`` by the
    run's own test; the program's, reported apart, stay within limits."""
    res = _run(name, control=True)
    assert not res["correct"], res["compared"]
    assert res["control"] is True and list(res)[-1] == "compared"
    assert all(v <= res["compared"][k]["limit"]
               for k, v in res["program"].items()), res["program"]


def _unchanged_step(monkeypatch):
    from sphax_torch.integrate import leapfrog, timestep

    def step(state, cfg, domain, derived_fn, dt=None, wrap=True):
        return state, (timestep.local_dt(state, cfg) if dt is None else dt)
    monkeypatch.setattr(leapfrog, "step", step)


def _half_rows(monkeypatch):
    """Half the rows of each derived pass keep their stale fields."""
    from sphax_torch.physics import wengine

    orig = wengine.derived_with

    def derived_with(state, wd, cfg, domain, spec_):
        out = orig(state, wd, cfg, domain, spec_)
        half = torch.arange(state.n) % 2 == 1
        return out._replace(**{
            k: torch.where(half if getattr(out, k).dim() == 1
                           else half[:, None], getattr(state, k),
                           getattr(out, k))
            for k in ("h", "rho", "acc", "du_dt", "divv")})
    monkeypatch.setattr(wengine, "derived_with", derived_with)


def _altered_forces(monkeypatch):
    """Kernel C's accelerations 1 % off where they are produced."""
    from sphax_torch.physics import wengine

    orig = wengine.stage_forces

    def stage_forces(*a, **kw):
        acc, du = orig(*a, **kw)
        return acc * 1.01, du
    monkeypatch.setattr(wengine, "stage_forces", stage_forces)


def _unchanged_tick(monkeypatch):
    """The rung tick's derived pass hands the stale state back."""
    from sphax_torch.integrate import rungs

    def derived(state, bf_prev, wd, cfg, domain, spec_, close_m):
        return state, bf_prev
    monkeypatch.setattr(rungs, "_derived_rungs", derived)


def _half_closers(monkeypatch):
    """Half the closing rows of a tick keep their stale fields."""
    from sphax_torch.integrate import rungs

    orig = rungs._derived_rungs

    def derived(state, bf_prev, wd, cfg, domain, spec_, close_m):
        half = close_m & (torch.arange(state.n) % 2 == 1)
        return orig(state, bf_prev, wd, cfg, domain, spec_, close_m & ~half)
    monkeypatch.setattr(rungs, "_derived_rungs", derived)


@pytest.mark.parametrize("fault", [_unchanged_step, _half_rows,
                                   _altered_forces])
@pytest.mark.parametrize("name", ["turb256.fixed", "sedov128.global"])
def test_global_faults_are_caught(monkeypatch, name, fault):
    fault(monkeypatch)
    res = _run(name)
    assert not res["correct"], res["compared"]


@pytest.mark.parametrize("fault", [_unchanged_tick, _half_closers,
                                   _altered_forces])
def test_rung_faults_are_caught(monkeypatch, fault):
    fault(monkeypatch)
    res = _run("sedov128.rungs3")
    assert not res["correct"], res["compared"]


def test_traced_run_reports_no_device_metric_on_the_cpu():
    res = _run("sedov128.rungs3", trace=1)
    assert res["correct"]
    assert set(res["metrics"]) <= {"active_frac.rungs"}
    assert res["device"]["busy_s"] == 0.0
