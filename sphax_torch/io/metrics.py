"""Structured JSONL metrics, a profiler hook and the program's spans
(torch twin of ``sphax.io.metrics``).

Every diagnostic interval appends one JSON line (t, energies, momentum,
Mach, throughput) to a run log, with the JAX version's keys;
``profile_trace`` wraps a step window in a ``torch.profiler`` trace written
as Chrome JSON.

``span(name)`` marks a layer of the program on the profiler's timeline,
the same clock as the device's kernels. The program emits the names of
``SPANS``, nested on the one host thread: ``sphax_torch.step`` (one step of
``wengine.simulate``) or ``sphax_torch.tick`` (one tick of
``rungs.simulate_rungs``) holds ``sphax_torch.build`` (``window.build``)
and ``sphax_torch.derived`` (a derived pass), which holds
``sphax_torch.kernel_a`` and ``sphax_torch.kernel_c`` (the wrappers of
kernels A and C, packing and checks included). A derived pass with P3M
gravity also holds ``MESH_SPAN``, ``sphax_torch.mesh``, around the FFT
mesh (``pm.mesh_accel``); a tick with the timestep limiter holds
``LIMIT_SPAN``, ``sphax_torch.limit``, around its pair passes and the
wake-up. They stay out of ``SPANS``, the spans of every path, which the
benchmark's idle split maps to its phases (their idle goes to the span
around them). So ``profile=1``'s Chrome trace carries them. A span is a
``torch.profiler.record_function`` range only while a profiler records;
otherwise it is one shared no-op context, whose cost (under a
microsecond, a few a step) nothing measures.

Beside the spans the program keeps counters, always on: the host
integers ``neighbors.window.BUILDS`` (window builds) and
``physics.pm.SOLVES`` (mesh solves), and
``neighbors.window.CANDIDATES["sums"]``, a device tensor [candidate rows,
rows] summed over the process's window builds. Each build adds the rows
kernel A's walk offers each row that defines windows (its group's
segments, as ``window.candidate_sums`` reads them off the build's own
tables) and the count of those rows, in a few small device reductions with
no host read. Read it once, after the work: candidates over rows is the
walk's mean candidates a row, which the pairs inside 2 h a row turn into
the walk's waste. The timestep limiter keeps ``integrate.rungs.LIMITED``
and ``WOKEN`` the same way (closers whose rung it lowered and closings,
rows the wake-up shortened and ticks).
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Optional

import torch

from sphax_torch.configs import SPHConfig
from sphax_torch.core.state import ParticleState
from sphax_torch.diag import conservation

# every span the program emits (``span``), outermost first
SPANS = ("sphax_torch.step", "sphax_torch.tick", "sphax_torch.build",
         "sphax_torch.derived", "sphax_torch.kernel_a",
         "sphax_torch.kernel_c")
# the P3M path's span inside ``sphax_torch.derived``, around the FFT mesh
MESH_SPAN = "sphax_torch.mesh"
# the rung path's span inside ``sphax_torch.tick`` around the timestep
# limiter's passes and the wake-up (``rungs.simulate_rungs(limiter=A)``)
LIMIT_SPAN = "sphax_torch.limit"

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A ``torch.profiler.record_function`` range named ``name`` (one of
    ``SPANS``, ``MESH_SPAN`` or ``LIMIT_SPAN``) while a profiler records,
    else a shared no-op context: an idle ``record_function`` is itself a
    dispatcher call, some ten times the cost of this check."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


class MetricsLogger:
    """Append-only JSONL logger with throughput bookkeeping."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)) or ".",
                        exist_ok=True)
        self._last_wall = time.time()
        self._last_step = 0
        self.records = []

    def log(self, state: ParticleState, cfg: SPHConfig, t: float, step: int,
            domain=None, cutoff=None, **extra) -> dict:
        """``domain`` and ``cutoff``: a periodic P3M run's, so that its
        record takes the P3M potential (``conservation.summary``)."""
        return self.log_record(conservation.summary(state, cfg, t, domain,
                                                    cutoff),
                               step, state.n, **extra)

    def log_record(self, rec: dict, step: int, n: int, **extra) -> dict:
        """Append a pre-computed record with throughput bookkeeping added
        (particle-steps per wall second since the previous record)."""
        now = time.time()
        rec = dict(rec)
        dsteps = step - self._last_step
        dwall = now - self._last_wall
        rec.update(step=int(step),
                   particle_steps_per_sec=(n * dsteps / dwall
                                           if dwall > 0 and dsteps > 0
                                           else 0.0),
                   **extra)
        self._last_wall, self._last_step = now, step
        self.records.append(rec)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        return rec

    @contextlib.contextmanager
    def untimed(self):
        """Leave the wall time of the work inside out of the next record's
        particle-steps rate."""
        t0 = time.time()
        try:
            yield
        finally:
            self._last_wall += time.time() - t0


@contextlib.contextmanager
def profile_trace(dirname: str):
    """Context manager: trace a step window with ``torch.profiler`` (host
    and, where a card is visible, CUDA activity) and write it to
    ``dirname/trace.json`` (Chrome trace format; open in Perfetto or
    chrome://tracing). The CUDA kernels appear under their template names,
    e.g. ``solve_h_density_pairs_kernel`` (kernel A),
    ``forces_pairs_kernel`` (kernel C) and ``forces_kernel`` (kernel C's
    gravity mode), and the host timeline under the program's ``SPANS``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(dirname, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(dirname, "trace.json"))
