"""Reduction of a ``torch.profiler`` trace of whole episodes.

Device operations (kernels, copies, sets) are classified by name with a
frozen copy of ``chip_smoke.py``'s kind table (see README.md); busy time is
the union of their intervals; an idle gap is a stretch of the traced window
with no device operation, named by what the host was doing then: the
innermost profiled host operation around the gap's middle, else the
benchmark's own span around it.
"""
from __future__ import annotations

import bisect
import dataclasses

KINDS = (("kernel A", ("solve_h_density",)), ("kernel C", ("forces_",)),
         ("sorts", ("RadixSort", "radix_sort", "Onesweep")),
         ("gathers and scatters", ("index", "gather", "scatter")),
         ("packing and copies", ("CatArray", "Memcpy", "copy")),
         ("reductions", ("reduce",)),
         ("elementwise", ("elementwise",)))


def kind(name: str) -> str:
    return next((k for k, pats in KINDS if any(p in name for p in pats)),
                "other")


@dataclasses.dataclass
class Trace:
    """Device operations [(name, start_us, end_us)], host operations
    likewise, and the traced window's length in seconds."""

    device: list
    host: list
    window_s: float
    ms: dict = dataclasses.field(default_factory=dict)      # by kind
    launches: dict = dataclasses.field(default_factory=dict)  # by kind
    busy_s: float = 0.0

    def __post_init__(self):
        for name, t0, t1 in self.device:
            k = kind(name)
            self.ms[k] = self.ms.get(k, 0.0) + (t1 - t0) / 1e3
            self.launches[k] = self.launches.get(k, 0) + 1
        self.busy_s = sum(b - a for a, b in merged(
            [(t0, t1) for _, t0, t1 in self.device])) / 1e6

    @property
    def total_ms(self) -> float:
        return sum(self.ms.values())

    def top_ops(self, k: int = 10):
        by = {}
        for name, t0, t1 in self.device:
            by[name] = by.get(name, 0.0) + (t1 - t0) / 1e6
        return sorted(([n[:160], s] for n, s in by.items()),
                      key=lambda x: -x[1])[:k]

    def idle_gaps(self, k: int = 10):
        """Idle device seconds summed by what the host was doing."""
        iv = merged([(t0, t1) for _, t0, t1 in self.device])
        host = sorted(self.host, key=lambda e: e[1])
        starts = [e[1] for e in host]
        spans = [e for e in host if e[0].startswith("portbench.")]
        by = {}
        for (_, a), (b, _) in zip(iv, iv[1:]):
            mid = 0.5 * (a + b)
            label = _around(host, starts, mid) or _around(
                spans, [e[1] for e in spans], mid) or "outside any span"
            by[label] = by.get(label, 0.0) + (b - a) / 1e6
        return sorted(([n[:160], s] for n, s in by.items()),
                      key=lambda x: -x[1])[:k]


def _around(events, starts, t, look: int = 400):
    """Name of the latest-starting event of ``events`` (sorted by start)
    that contains ``t``, looking back ``look`` events."""
    i = bisect.bisect_right(starts, t)
    for e in reversed(events[max(0, i - look):i]):
        if e[2] >= t:
            return e[0]
    return None


def merged(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def from_profiler(prof, window_s: float) -> Trace:
    """The device and host operations of a finished ``torch.profiler``."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.events():
        tr = e.time_range
        item = (e.name, float(tr.start), float(tr.end))
        if getattr(e, "is_user_annotation", False) and \
                e.device_type == DeviceType.CUDA:
            continue    # a span's shadow on the device timeline, no work
        if e.device_type == DeviceType.CUDA:
            dev.append(item)
        elif e.device_type == DeviceType.CPU:
            host.append(item)
    return Trace(device=dev, host=host, window_s=window_s)
