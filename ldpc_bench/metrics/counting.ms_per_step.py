"""Device milliseconds per Monte-Carlo step of counting.

The device time of the operations launched inside the port's ``sim.count``
spans (``harness/spans.py``): the hard decisions, the per-codeword bit
errors over the counted prefix, the step's three sums, over the traced
window's steps (those whose operations the window holds whole). Nothing is
read without the spans or a pairing of launches with operations.
"""

from ldpc_bench.harness import spans

UNIT = "ms"
LAYER = "counting"
MOVES = "coded_mbps"
WORKLOADS = None  # every cell


def read(trace):
    return spans.device_ms_per_step(trace, "sim.count")
