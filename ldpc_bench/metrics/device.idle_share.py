"""The share of the traced window in which nothing ran on the card.

One minus the union of the device's operations (kernels, copies, fills) over
the window's wall time, both from the same profiled window: from the start
of a dispatch to the return of the last dispatch's counters to the host.
"""

UNIT = "%"
LAYER = "device"
MOVES = "coded_mbps"
WORKLOADS = None  # every cell


def read(trace):
    if trace.window_us <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_us / trace.window_us)
