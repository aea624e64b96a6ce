"""Profiling helpers: a ``torch.profiler`` trace around a region, and the
engine's spans.

Port of ``utils/profiling.py``. The per-point results
(``sim.engine.PointResult``) carry the throughput; :func:`device_trace` adds
the device-level view, a Chrome trace (``chrome://tracing``, Perfetto or
TensorBoard's profiler plugin) with each kernel's time and the engine's
spans (:func:`span`) around them.
"""

from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()
_profiler_enabled = torch._C._autograd._profiler_enabled
# A range made in C++, as PyTorch's compiled code names its Triton launches:
# under the profiler it costs 1.1-1.8 us on an H100's host (torch 2.11),
# where ``torch.profiler.record_function``, a call through the dispatcher,
# costs 11-13 us.
_range = torch._C._profiler._RecordFunctionFast


def span(name: str):
    """A profiler range ``name`` while ``torch.profiler`` records
    (the benchmark's traced run, :func:`device_trace`), else one shared no-op
    context manager: with nothing recording a span costs one check."""
    return _range(name) if _profiler_enabled() else _OFF


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
