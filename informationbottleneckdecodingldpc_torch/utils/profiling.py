"""Profiling helpers: a ``torch.profiler`` trace around a region, and a
wall-clock bracket.

Port of ``utils/profiling.py``. The per-point results
(``sim.engine.PointResult``) carry the throughput; :func:`device_trace` adds
the device-level view, a Chrome trace (``chrome://tracing``, Perfetto or
TensorBoard's profiler plugin) with each kernel's time.
"""

from __future__ import annotations

import contextlib
import time

import torch


@contextlib.contextmanager
def device_trace(trace_dir: str | None):
    """Trace the region with ``torch.profiler`` (CPU activity, and CUDA on a
    host with a card) and write a Chrome trace ``*.pt.trace.json`` into
    ``trace_dir``; do nothing when it is None."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(trace_dir)):
        yield


@contextlib.contextmanager
def wallclock(label: str, sink=print):
    """Print the wall-clock seconds of the region through ``sink``."""
    t0 = time.time()
    yield
    sink(f"{label}: {time.time() - t0:.3f} s")
