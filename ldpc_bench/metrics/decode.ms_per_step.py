"""Device milliseconds per Monte-Carlo step of the decode kernels.

The sum of the durations of the decode kernels in the traced window over
the steps it ran: K1 (``ib_lut_fused_kernel``), K2 (``float_fused_kernel``)
and the passes of K3 and K4 (seed, check, variable, syndrome, tile-exit and
decision kernels). Nothing is read when no decode kernel ran in the window.
"""

UNIT = "ms"
LAYER = "decode"
MOVES = "coded_mbps"
WORKLOADS = None  # every cell

DECODE_KERNELS = ("ib_lut_fused_kernel", "float_fused_kernel", "seed_kernel", "cn_kernel",
                  "vn_kernel", "syndrome_kernel", "exit_kernel", "decide_kernel")


def is_decode(name):
    return any(k in name for k in DECODE_KERNELS)


def read(trace):
    us = [e.duration for e in trace.device if is_decode(e.name)]
    if not us or trace.steps <= 0:
        return None
    return sum(us) / 1e3 / trace.steps
