"""Host milliseconds to issue one Monte-Carlo step.

The summed duration of the traced window's ``sim.step`` spans (the port's
engine, ``harness/spans.py``) over its steps: the host's time from a step's
key to its last launch. Beside ``decode.ms_per_step`` it says whether the
host or the card sets the pace. Nothing is read unless the spans count
every step of the window.
"""

from ldpc_bench.harness import spans

UNIT = "ms"
LAYER = "host loop"
MOVES = "coded_mbps"
WORKLOADS = None  # every cell


def read(trace):
    n = spans.steps(trace)
    if n is None:
        return None
    return sum(s.duration for s in spans.spans(trace, "sim.step")) / 1e3 / n
