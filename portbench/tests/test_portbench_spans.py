"""The split of the device's idle time by the program's spans
(``portbench/spans.py``): exact on a made-up trace, cut at every span's
edges, silent where the program emits no span, and counting the builds of
a traced run on the CPU."""
import pytest
import torch

from portbench import run, spans, spec
from portbench.trace import Trace

IDLE = [f"idle_{p}_ms_per_tick.rungs" for p in
        ("build", "derived", "kernels", "integrate", "outside")]
NEW = IDLE + [m.replace(".rungs", ".sedov") for m in IDLE] + [
    "host_ms_per_tick.rungs", "host_ms_per_tick.sedov",
    "build_spans_per_step.turb"]


class Run:
    def __init__(self, trace, steps):
        self.trace, self.counters = trace, {"steps": steps}


def _trace():
    """Device operations leave idle gaps (10, 20), (30, 50), (60, 100) and
    (110, 130) us; a tick holds a build and a derived pass, which holds
    kernels A and C; host operations of other names are not spans."""
    device = [("k", 0, 10), ("k", 20, 30), ("k", 50, 60), ("k", 100, 110),
              ("k", 130, 140)]
    host = [("portbench.chunk", 0, 140), ("sphax_torch.tick", 5, 105),
            ("sphax_torch.build", 8, 25), ("aten::add", 12, 14),
            ("sphax_torch.derived", 28, 90), ("sphax_torch.kernel_a", 35, 45),
            ("sphax_torch.kernel_c", 70, 80), ("cudaLaunchKernel", 71, 72)]
    return Trace(device=device, host=host, window_s=140e-6)


def test_the_phases_partition_the_idle_time():
    t = _trace()
    by = spans.split(t)
    assert by == {"build": 10.0, "derived": 30.0, "kernels": 20.0,
                  "integrate": 10.0, "outside": 20.0}
    idle = sum(b - a for a, b in spans.idle_gaps(t))
    assert idle == 90.0
    assert abs(sum(by.values()) - idle) <= 1e-9 * idle
    got = [spec.reader(m)(Run(t, 2)) for m in IDLE]
    assert got == pytest.approx([v / 1e3 / 2 for v in by.values()],
                                rel=1e-12)
    assert abs(sum(got) - idle / 1e3 / 2) <= 1e-9 * idle / 1e3
    # the host was inside a program span from 5 to 105 us
    assert spec.reader("host_ms_per_tick.rungs")(Run(t, 2)) == \
        pytest.approx(0.1 / 2, rel=1e-12)


def test_a_gap_is_cut_at_a_childs_edges():
    """A step covers the first part of the gap, its build the middle, no
    span the end."""
    t = Trace(device=[("k", 0, 10), ("k", 40, 50)],
              host=[("sphax_torch.step", 5, 30),
                    ("sphax_torch.build", 20, 30)], window_s=50e-6)
    assert spans.split(t) == {"build": 10.0, "derived": 0.0, "kernels": 0.0,
                              "integrate": 10.0, "outside": 10.0}


def test_no_reading_without_program_spans():
    """A program that emits no span (the benchmark's parent commit) reads
    nothing, and neither does a trace with no device operation."""
    t = _trace()
    bare = Trace(device=t.device, host=[e for e in t.host
                                        if not e[0].startswith("sphax")],
                 window_s=t.window_s)
    no_dev = Trace(device=[], host=t.host, window_s=t.window_s)
    for m in NEW:
        assert spec.reader(m)(Run(bare, 2)) is None, m
        if m != "build_spans_per_step.turb":
            assert spec.reader(m)(Run(no_dev, 2)) is None, m


def test_the_frozen_names_are_the_programs():
    from sphax_torch.io import metrics

    assert tuple(spans.PHASES) == metrics.SPANS


@pytest.fixture
def window_engine_on_cpu(monkeypatch):
    """The window engine's plain versions as the card's path on the CPU
    (as in test_portbench_check.py)."""
    from sphax_torch import problems

    def auto(st, cfg, dom, h_margin=1.3, cutoff_scale=1.25):
        eng, sp = problems._window_engine(st, cfg, dom, h_margin,
                                          cutoff_scale)
        return eng, sp, "window"
    monkeypatch.setattr(problems, "_auto_engine", auto)


def test_a_traced_run_counts_its_builds(window_engine_on_cpu):
    res, _ = run.execute(spec.cell("turb256.fixed"), 2**31 + 11, 0.01, 1,
                         torch.device("cpu"),
                         override=dict(n=12, chunk=2, episode_chunks=2))
    assert res["correct"], res["compared"]
    m = res["metrics"]
    assert m["build_spans_per_step.turb"]["value"] == \
        m["builds_per_step.turb"]["value"] == 0.5
