"""Milliseconds from a dispatch's start to its first launch.

The mean, over the traced window's dispatches (the port's ``sim.dispatch``
spans, ``harness/spans.py``), of the time from the span's start to the
first launch call inside it: the device's idle at the head of every
dispatch, short of the launch's own latency, while the host draws the key
and issues the first launch. Both ends are on the host's clock, since the
profiler's device times drift against it on the card's machine. Nothing is
read without the program's spans.
"""

import bisect

from ldpc_bench.harness import spans

UNIT = "ms"
LAYER = "host loop"
MOVES = "dispatch_ms_p95"
WORKLOADS = None  # every cell


def read(trace):
    starts = [c.start for c in spans.launch_calls(trace)]
    gaps = []
    for d in spans.spans(trace, "sim.dispatch"):
        i = bisect.bisect_left(starts, d.start)
        if i < len(starts) and starts[i] < d.end:
            gaps.append(starts[i] - d.start)
    return sum(gaps) / len(gaps) / 1e3 if gaps else None
