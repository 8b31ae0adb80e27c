"""The 2D cell ``kh1024.fixed`` on the CPU at a small size, past the
harness's look for a card: a sound run comes out correct; the control (the
2D reference in TF32 in the program's place) and runs with the timed path
broken do not. And the 2D pair counter against brute force."""
import pytest
import torch

from portbench import run, spec, yardstick_2d

CELL = "kh1024.fixed"
SMALL = dict(n=16, chunk=2, episode_chunks=2)


@pytest.fixture(autouse=True)
def window_engine_on_cpu(monkeypatch):
    """The problems take the window engine on a card; on the CPU the
    registry would take the dense engine, so the tests take the window
    engine's plain versions as the card's path."""
    from sphax_torch import problems

    def auto(st, cfg, dom, h_margin=1.3, cutoff_scale=1.25):
        eng, sp = problems._window_engine(st, cfg, dom, h_margin,
                                          cutoff_scale)
        return eng, sp, "window"
    monkeypatch.setattr(problems, "_auto_engine", auto)


def _run(seed=2**31 + 7, control=False, trace=0):
    from sphax_torch.neighbors import window

    # the program's candidate counter sums over the process's builds: a
    # run of the benchmark is one process
    window.CANDIDATES["sums"] = None
    res, lines = run.execute(spec.cell(CELL), seed, 0.01, trace,
                             torch.device("cpu"), override=SMALL,
                             control=control)
    assert lines[-1].startswith(list(res["compared"])[-1])
    return res


@pytest.mark.parametrize("seed", [2**31 + 7, 12345])
def test_sound_run_is_correct(seed):
    res = _run(seed)
    assert res["correct"], res["compared"]
    assert set(res["compared"]) == {"start_err", "step_err"}


def test_the_control_in_the_programs_place_is_not_correct():
    res = _run(control=True)
    assert not res["correct"], res["compared"]
    assert res["control"] is True
    assert all(v <= res["compared"][k]["limit"]
               for k, v in res["program"].items()), res["program"]


def _unchanged_step(monkeypatch):
    from sphax_torch.integrate import leapfrog, timestep

    def step(state, cfg, domain, derived_fn, dt=None, wrap=True):
        return state, (timestep.local_dt(state, cfg) if dt is None else dt)
    monkeypatch.setattr(leapfrog, "step", step)


def _altered_forces(monkeypatch):
    """Kernel C's accelerations 1 % off where they are produced."""
    from sphax_torch.physics import wengine

    orig = wengine.stage_forces

    def stage_forces(*a, **kw):
        acc, du = orig(*a, **kw)
        return acc * 1.01, du
    monkeypatch.setattr(wengine, "stage_forces", stage_forces)


@pytest.mark.parametrize("fault", [_unchanged_step, _altered_forces])
def test_faults_are_caught(monkeypatch, fault):
    fault(monkeypatch)
    res = _run()
    assert not res["correct"], res["compared"]


def test_pair_counter_against_brute_force():
    g = torch.Generator().manual_seed(3)
    pos = torch.rand(500, 2, generator=g, dtype=torch.float64)
    h = 0.01 + 0.02 * torch.rand(500, generator=g, dtype=torch.float64)

    def brute(h):
        d = pos[:, None, :] - pos[None, :, :]
        d = d - torch.round(d)
        r = torch.sqrt((d * d).sum(-1))
        return (int((r < 2 * h[:, None]).sum()),
                int(((r < 2 * torch.maximum(h[:, None], h[None, :]))
                     & (r > 0)).sum()))
    for scale in (1.0, 4.0, 9.0):     # many cells, 3 a side, all pairs
        assert yardstick_2d.pair_counts(pos, h * scale, block=64) == \
            brute(h * scale)


def test_traced_run_reports_no_device_metric_on_the_cpu():
    """The device metrics need a card; the program's candidate counter is
    read on the CPU too."""
    res = _run(trace=1)
    assert res["correct"]
    assert set(res["metrics"]) == {"cand_per_pair.kh"}
    assert 10 < res["metrics"]["cand_per_pair.kh"]["value"] < 100
    assert res["device"]["busy_s"] == 0.0
