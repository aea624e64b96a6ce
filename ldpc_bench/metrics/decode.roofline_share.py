"""The decode kernels' share of their bound, per step.

The bound is the least time a decode of the step's codewords could take on
an H100 SXM (``harness/roofline.py``, a frozen copy of the port's
``decode_bound`` arithmetic): the larger of the bytes over 3.35 TB/s and the
lookups (IB) or compares and adds (min-sum) over the data sheet's rates,
counted from the configuration's graph and tables with the mean bodies the
run's own counters report. Divided by ``decode.ms_per_step``.
"""

from ldpc_bench.harness import roofline

UNIT = "%"
LAYER = "decode"
MOVES = "coded_mbps"
WORKLOADS = None  # every cell


def read(trace):
    decode_ms = trace.value("decode.ms_per_step")
    if not decode_ms:
        return None
    g, kind = trace.graph, trace.cell["config_spec"]["decoder"]["kind"]
    ops = roofline.decode_ops(kind, g["check_degrees"], g["var_degrees"], trace.batch,
                              trace.mean_bodies, g["alignment"])
    moved = roofline.decode_bytes(g["n_vars"], trace.batch, g["table_elements"] if kind == "ib" else 0)
    return 100.0 * roofline.bound_ms(moved, ops)["bound_ms"] / decode_ms
