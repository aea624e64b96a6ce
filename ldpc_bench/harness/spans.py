"""Give each device operation of the traced window to the program's span
that launched it.

The port marks the layers of its engine with profiler ranges named
``sim.<what>``, nested as the work is: ``sim.run_point`` holds a
``sim.dispatch`` per dispatch, which holds its ``sim.step`` ranges and its
``sim.readback``; a step holds ``sim.seed``, ``sim.channel_input`` (with
``sim.encode`` inside it on the encoded chains), ``sim.decode`` and
``sim.count``. A program without them gives no span, and every reading
of them is None.

A device operation (kernel, copy, fill) is launched by a host call of the
CUDA API (:data:`LAUNCHES`). On an H100 with torch 2.11 and
CUDA 12.8 the four cells' windows hold ``cudaLaunchKernel`` (torch's
kernels and the port's own, launched from its ctypes libraries),
``cudaLaunchKernelExC`` (cuBLAS's GEMM in the WLAN encoder),
``cudaMemcpyAsync`` (the readback) and ``cudaMemsetAsync`` (a fill in
counting on DVB-S2), one for each device operation; ``cuLaunchKernel`` and
``cuLaunchKernelEx`` are there for kernels launched as Triton launches
them.

The port issues all its work on one stream, so the window's launch calls
and its device operations, each by start time, are the same work in the
same order, and each operation goes to the innermost ``sim.*`` span that
holds its launch call. The pairing never reads a time across the two
clocks: on the card's machine the profiler's device times drift against
the host's by up to 2.4 ms in a window (operations that begin before
their launch calls), so the window, cut on the host's clock, can lose the
operations at either end. The operations that remain are then matched to
the calls at the one offset where every copy meets a copy call, every
fill a fill call and every kernel a kernel launch, and a step with a call
left unpaired is left out. With no such offset, or more than one, nothing
is paired (:func:`attribute` returns None) and the metrics that read it
read nothing.
"""

from __future__ import annotations

import dataclasses

from .trace import Event

PREFIX = "sim."
LAUNCHES = frozenset({
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
    "cudaMemcpyAsync", "cudaMemsetAsync",
})
_CALL_KIND = {"cudaMemcpyAsync": "c", "cudaMemsetAsync": "f"}  # any other launch call: a kernel


def _op_kind(name: str) -> str:
    return "c" if name.startswith("Memcpy") else "f" if name.startswith("Memset") else "k"


def spans(trace, name: str) -> list[Event]:
    """The window's spans ``name``, by start."""
    return sorted((e for e in trace.host if e.name == name and trace.lo <= e.start and e.end <= trace.hi),
                  key=lambda e: e.start)


def steps(trace) -> int | None:
    """The window's steps, when its ``sim.step`` spans count them all."""
    n = len(spans(trace, "sim.step"))
    return n if n and n == trace.steps else None


def launch_calls(trace) -> list[Event]:
    """The window's launch calls, by start."""
    return sorted((e for e in trace.host if e.name in LAUNCHES and trace.lo <= e.start < trace.hi),
                  key=lambda e: e.start)


def _open_spans(nested: list[Event], calls: list[Event]) -> list[tuple[Event, ...]]:
    """For each call (by start), the spans of ``nested`` (by start, outer
    first at equal starts) open at its start, outermost first."""
    out, stack, i = [], [], 0
    for c in calls:
        while i < len(nested) and nested[i].start <= c.start:
            stack.append(nested[i])
            i += 1
        stack = [s for s in stack if s.end > c.start]
        out.append(tuple(stack))
    return out


@dataclasses.dataclass(frozen=True)
class Attribution:
    """The window's paired device operations, each with the ``sim.*`` spans
    open around its launch call, outermost first, and the steps left out:
    those with a launch call whose operation the window lost."""

    ops: list[Event]
    within: list[tuple[Event, ...]]
    cut: frozenset

    def device_us(self, name: str) -> float:
        """Device microseconds of the operations whose innermost span is
        ``name``, in the steps not left out."""
        return sum(op.duration for op, open_ in zip(self.ops, self.within)
                   if open_ and open_[-1].name == name and not self.cut.intersection(open_))


def attribute(trace) -> Attribution | None:
    """The pairing of the window's launch calls with its device operations,
    or None when no single offset matches their kinds."""
    calls = launch_calls(trace)
    ops = sorted(trace.device, key=lambda e: e.start)
    want = "".join(_op_kind(op.name) for op in ops)
    have = "".join(_CALL_KIND.get(c.name, "k") for c in calls)
    fits = [p for p in range(len(have) - len(want) + 1) if have[p:p + len(want)] == want]
    if len(fits) != 1:
        return None
    p = fits[0]
    nested = sorted((e for e in trace.host if e.name.startswith(PREFIX)), key=lambda e: (e.start, -e.end))
    within = _open_spans(nested, calls)
    cut = frozenset(s for i, open_ in enumerate(within) if not p <= i < p + len(ops)
                    for s in open_ if s.name == "sim.step")
    return Attribution(ops, within[p:p + len(ops)], cut)


def device_ms_per_step(trace, name: str) -> float | None:
    """Device milliseconds a step of the operations attributed to the spans
    ``name``, over the steps not left out; None without such spans or a
    pairing."""
    if steps(trace) is None or not spans(trace, name):
        return None
    pairs = attribute(trace)
    if pairs is None:
        return None
    whole = len(spans(trace, "sim.step")) - len(pairs.cut)
    return pairs.device_us(name) / 1e3 / whole if whole > 0 else None
