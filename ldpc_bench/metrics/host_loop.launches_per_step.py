"""Launches a Monte-Carlo step: every kernel, copy and fill.

The CUDA launch calls (``harness/spans.py`` ``LAUNCHES``) made inside the
traced window's ``sim.step`` spans, over its steps; a fused kernel or a
replayed graph shows here as a whole number. Nothing is read unless the
spans count every step of the window.
"""

import bisect

from ldpc_bench.harness import spans

UNIT = "launches"
LAYER = "host loop"
MOVES = "coded_mbps"
WORKLOADS = None  # every cell


def read(trace):
    n = spans.steps(trace)
    if n is None:
        return None
    starts = [c.start for c in spans.launch_calls(trace)]
    return sum(bisect.bisect_left(starts, s.end) - bisect.bisect_left(starts, s.start)
               for s in spans.spans(trace, "sim.step")) / n
