"""The device's idle time split by what the program was doing.

The program marks its layers with ``torch.profiler.record_function`` spans
while a profiler records (``sphax_torch.io.metrics.span``); they share the
profiler's clock with the device operations. ``PHASES`` is a frozen copy of
the program's span names (``sphax_torch.io.metrics.SPANS``), each mapped to
a phase; nothing of the program is imported. Each idle stretch between two
device operations of the traced window is cut at the spans' edges, and each
piece goes to the innermost program span around it, or to ``outside``
where the host was in none: the phases partition the idle time. Everything
here reads only a ``trace.Trace``'s host and device operations.
"""
from __future__ import annotations

from portbench.trace import merged

PHASES = {"sphax_torch.step": "integrate", "sphax_torch.tick": "integrate",
          "sphax_torch.build": "build", "sphax_torch.derived": "derived",
          "sphax_torch.kernel_a": "kernels",
          "sphax_torch.kernel_c": "kernels"}
ORDER = ("build", "derived", "kernels", "integrate", "outside")


def program_spans(trace):
    """The program's spans [(start_us, end_us, name)], by start, the
    outer of two that start together first."""
    return sorted(((a, b, name) for name, a, b in trace.host
                   if name in PHASES), key=lambda s: (s[0], -s[1]))


def innermost(spans):
    """Cut the host timeline at the spans' edges: [(t0, t1, phase)] of the
    innermost span over each piece, in time order, where any span runs."""
    out, stack, cur = [], [], None

    def emit(t1, phase):
        if t1 > cur:
            out.append((cur, t1, phase))

    for a, b, name in spans:
        while stack and stack[-1][0] <= a:
            end, phase = stack.pop()
            emit(end, phase)
            cur = end
        if stack:
            emit(a, stack[-1][1])
            b = min(b, stack[-1][0])      # a child ends inside its parent
        cur = a
        stack.append((b, PHASES[name]))
    while stack:
        end, phase = stack.pop()
        emit(end, phase)
        cur = end
    return out


def idle_gaps(trace):
    """The device's idle stretches [(start_us, end_us)] between the merged
    device operations of the traced window."""
    iv = merged([(t0, t1) for _, t0, t1 in trace.device])
    return [(b, a) for (_, b), (a, _) in zip(iv, iv[1:])]


def split(trace):
    """Idle device microseconds by phase (``ORDER``), or None where the
    trace holds no device operation or no program span."""
    spans = program_spans(trace)
    if not trace.device or not spans:
        return None
    segs = innermost(spans)
    by = dict.fromkeys(ORDER, 0.0)
    i = 0
    for g0, g1 in idle_gaps(trace):
        covered = 0.0
        while i < len(segs) and segs[i][1] <= g0:
            i += 1
        j = i
        while j < len(segs) and segs[j][0] < g1:
            s0, s1, phase = segs[j]
            part = min(s1, g1) - max(s0, g0)
            if part > 0:
                by[phase] += part
                covered += part
            j += 1
        by["outside"] += (g1 - g0) - covered
    return by


def idle_ms_per_tick(run, phase: str):
    """Idle device ms a tick (a global step counts as a tick) while the
    host was in ``phase``; None without device operations or spans."""
    by = split(run.trace) if run.trace is not None else None
    if by is None or not run.counters["steps"]:
        return None
    return by[phase] / 1e3 / run.counters["steps"]


def host_ms_per_tick(run):
    """Host ms a tick inside the program's spans: the union of their
    intervals (the top-level spans' host time), over the ticks; None
    without device operations or spans."""
    t = run.trace
    spans = program_spans(t) if t is not None else []
    if t is None or not t.device or not spans or not run.counters["steps"]:
        return None
    busy = sum(b - a for a, b in merged([(a, b) for a, b, _ in spans]))
    return busy / 1e3 / run.counters["steps"]


def count_per_step(run, name: str):
    """Spans named ``name`` in the traced window, over its steps; None
    where the trace holds no program span."""
    t = run.trace
    spans = program_spans(t) if t is not None else []
    if not spans or not run.counters["steps"]:
        return None
    return sum(1 for _, _, n in spans if n == name) / run.counters["steps"]
