"""Device milliseconds per Monte-Carlo step of the channel input.

Every device operation of a step from its first Philox launch
(``channel_input_kernel``: the info bits of the encoded chain, or the whole
input) to its first decode kernel, the encoder included, summed over the
traced window and divided by its steps (the port's ``channel_input_ms``
arithmetic). Nothing is read when no step reached a decode kernel.
"""

UNIT = "ms"
LAYER = "channel input"
MOVES = "coded_mbps"
WORKLOADS = None  # every cell

DRAW_KERNEL = "channel_input_kernel"


def read(trace):
    is_decode = trace.reader("decode.ms_per_step").is_decode
    total, inside, decoded = 0.0, False, False
    for e in sorted(trace.device, key=lambda e: e.start):
        if is_decode(e.name):
            inside, decoded = False, True
            continue
        inside = inside or DRAW_KERNEL in e.name
        if inside:
            total += e.duration
    if not decoded or trace.steps <= 0:
        return None
    return total / 1e3 / trace.steps
