"""Structured JSONL metrics and a profiler hook (torch twin of
``sphax.io.metrics``).

Every diagnostic interval appends one JSON line (t, energies, momentum,
Mach, throughput) to a run log, with the JAX version's keys;
``profile_trace`` wraps a step window in a ``torch.profiler`` trace written
as Chrome JSON.
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
            **extra) -> dict:
        return self.log_record(conservation.summary(state, cfg, t),
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
    e.g. ``solve_h_density_kernel`` and ``forces_kernel``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(dirname, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(dirname, "trace.json"))
