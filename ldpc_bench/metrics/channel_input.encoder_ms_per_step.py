"""Device milliseconds per Monte-Carlo step of the encoder.

The device time of the operations launched inside the port's ``sim.encode``
spans (``harness/spans.py``: each operation goes to the innermost span of
its launch call) over the traced window's steps (those whose operations
the window holds whole): the encoded chain's encoder apart from the Philox
kernel that draws its info bits. Read in the encoded cells; nothing is
read without the spans or a pairing of launches with operations.
"""

from ldpc_bench.harness import spans

UNIT = "ms"
LAYER = "channel input"
MOVES = "coded_mbps"
WORKLOADS = ["dvbs2_ib.enc_b1024", "wlan_ib.queue_enc512", "dvbs2_ib.queue_enc128"]


def read(trace):
    return spans.device_ms_per_step(trace, "sim.encode")
