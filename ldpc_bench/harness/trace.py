"""Reduce a profiled window to the numbers the per-layer metrics read.

An event is (name, start us, end us). Device events are what ran on the
card (kernels, copies, fills); host events are the profiler's CPU ranges
(the benchmark's own spans, torch operators, CUDA runtime calls). The
window is the benchmark's span around the traced dispatches: from the
start of the first dispatch to the moment the last one's counters were
back on the host.
"""

from __future__ import annotations

import collections
import dataclasses

WINDOW_SPAN = "ldpc_bench.traced_window"
SPAN_PREFIX = "ldpc_bench."  # the benchmark's own spans, which the profiler also draws on the device


@dataclasses.dataclass(frozen=True)
class Event:
    name: str
    start: float  # us
    end: float  # us

    @property
    def duration(self) -> float:
        return self.end - self.start


def from_profiler(prof) -> tuple[list[Event], list[Event]]:
    """(device events, host events) of a finished ``torch.profiler`` run. A
    span's copy on the device's timeline (a user annotation, which covers
    the kernels launched inside it) is no device operation and is left out."""
    from torch.autograd import DeviceType

    device, host = [], []
    for e in prof.events():
        ev = Event(e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type != DeviceType.CUDA:
            host.append(ev)
        elif not (getattr(e, "is_user_annotation", False) or e.name.startswith(SPAN_PREFIX)):
            device.append(ev)
    return device, host


def window(host: list[Event]) -> tuple[float, float]:
    """The traced window's (start, end) from its span."""
    spans = [e for e in host if e.name == WINDOW_SPAN]
    if len(spans) != 1:
        raise RuntimeError(f"expected one {WINDOW_SPAN} span, found {len(spans)}")
    return spans[0].start, spans[0].end


def clip(events: list[Event], lo: float, hi: float) -> list[Event]:
    """The parts of ``events`` inside [lo, hi]."""
    return [Event(e.name, max(e.start, lo), min(e.end, hi)) for e in events
            if e.end > lo and e.start < hi]


def union(events: list[Event]) -> list[tuple[float, float]]:
    """The merged intervals the events cover, in order."""
    merged: list[list[float]] = []
    for e in sorted(events, key=lambda e: e.start):
        if merged and e.start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e.end)
        else:
            merged.append([e.start, e.end])
    return [(a, b) for a, b in merged]


def busy(events: list[Event], lo: float, hi: float) -> float:
    """Microseconds of [lo, hi] in which some device event ran."""
    return sum(b - a for a, b in union(clip(events, lo, hi)))


def gaps(events: list[Event], lo: float, hi: float) -> list[tuple[float, float]]:
    """The idle intervals of [lo, hi] between device events."""
    out, t = [], lo
    for a, b in union(clip(events, lo, hi)):
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out


def host_call(host: list[Event], t: float) -> str:
    """The innermost host range running at ``t`` (the window's span aside)."""
    running = [e for e in host if e.start <= t < e.end and e.name != WINDOW_SPAN]
    return min(running, key=lambda e: e.duration).name if running else "host"


def breakdown(device: list[Event], host: list[Event], lo: float, hi: float, top: int = 10) -> dict:
    """The device operations that took most time and the longest idle gaps,
    each with the host call running at its middle, in seconds."""
    per_op = collections.Counter()
    for e in clip(device, lo, hi):
        per_op[e.name] += e.duration / 1e6
    idle = sorted(gaps(device, lo, hi), key=lambda g: g[0] - g[1])[:top]
    return {
        "device_ops": [[name, s] for name, s in per_op.most_common(top)],
        "idle_gaps": [[host_call(host, (a + b) / 2), (b - a) / 1e6] for a, b in idle],
    }


class Trace:
    """What a metric reader gets: the traced window's device and host events,
    the window, the work done in it (steps, codewords, mean bodies from the
    run's own counters) and the cell's description (``cell``: the workload
    with its configuration, ``graph``: degree counts and table entries).
    :meth:`reader` gives another metric's module, :meth:`value` its
    reading."""

    def __init__(self, device: list[Event], host: list[Event], lo: float, hi: float, *,
                 steps: int, batch: int, mean_bodies: float, cell: dict, graph: dict, readers: dict):
        self.device, self.host, self.lo, self.hi = clip(device, lo, hi), host, lo, hi
        self.steps, self.batch, self.mean_bodies = steps, batch, mean_bodies
        self.cell, self.graph = cell, graph
        self._readers, self._values = readers, {}

    @property
    def window_us(self) -> float:
        return self.hi - self.lo

    @property
    def busy_us(self) -> float:
        return busy(self.device, self.lo, self.hi)

    def reader(self, name: str):
        """The module of the metric ``name``."""
        return self._readers[name]

    def value(self, name: str) -> float | None:
        if name not in self._values:
            self._values[name] = self._readers[name].read(self)
        return self._values[name]
