"""Roofline of the benchmark matrix: work counts, bounds and the copy bandwidth.

Port of the roofline half of ``scripts/bench_matrix.py``. A cell's
speed-of-light is the coded bits/s its decoder could reach if it ran at the
measured peak rate of its primitives (``utils/peaks.py``, K5) or, for a
decoder whose message views live in device memory, at the measured copy
bandwidth (the faster of K6, :func:`measure_hbm_bandwidth`, and torch's
``copy_``: :func:`traffic_bandwidth`), whichever is smaller. The
formulas are the JAX script's (``:379-451``), so a fraction of the port means
what a fraction of the JAX matrix meant:

- IB: t_iter = n_2d / peak_2d + n_1d / peak_1d per codeword, from
  :func:`ib_lookup_counts` (the lookups K1 and K3 make; the JAX script
  counted the TPU's packed column builds and extracts instead); peak_2d is
  the faster of K5b's two table layouts (``utils/peaks.py``
  ``lookup2d_peak``);
- BP: the check nodes' box-plus applications over the box-plus peak;
- min-sum: 4 ops per check-node edge against 7 x the min-sum op peak;
- traffic, for a cell on ``backend='hbm'``: the view bytes per codeword and
  body of the kernel that runs (K3: both views read and written and the
  channel plane read, 4 n_edges + n_vars messages at a byte, or half a byte
  where its tables give |T| <= 16; K4: 16 n_edges, as ``:440`` counts the
  float32 views) over the copy bandwidth.

Every bound takes the measured mean iteration count as i_eff.

:func:`decode_bound` is the other bound, the one a kernel's record states:
the larger of the bytes the decode must move (its input read once, its
outputs written once) over the data sheet's memory rate and the operations
it does, each class over its own rate (:data:`DATA_SHEET_OPS_PER_S`, the
CUDA C++ Programming Guide's per-pipe rates for compute capability 9.0 and
the issue limit; :func:`bound` does the arithmetic for any kernel).
"""

from __future__ import annotations

import collections
import math
from typing import Callable

import numpy as np
import torch

from ..construct.trellis import TrellisTables
from ..decode.graph_arrays import DecodeLayout
from ..kernels import hbm_copy, philox_planes
from ..kernels.float_hbm import takes_node_state
from ..kernels.ib_lut_hbm import view_bits
from .peaks import _cuda, differenced_rate, lookup2d_peak

# NVIDIA H100 SXM data sheet: 132 SMs at a 1.98 GHz boost clock and device
# memory at 3.35 TB/s. Per SM and clock, from the CUDA C++ Programming
# Guide's arithmetic instruction throughput for compute capability 9.0: 128
# 32-bit float adds, multiplies and multiply-adds (the data sheet's 67
# TFLOP/s count an FMA as two operations); 64 compares, minimums and
# maximums; 16 special-function operations (reciprocal, square root,
# logarithm, exponential, sine, cosine) and 16 of "all other type
# conversions" (32-bit integer to float among them); 64 32-bit integer
# multiplies and 64 32-bit logic operations; 32 shared-memory loads (one
# warp's: a table lookup each), and 32 words of shared memory (128 bytes),
# which a wider load spends in fewer instructions. Whatever the pipe, each of an SM's four
# sub-partitions issues one warp instruction per clock: 128 thread
# instructions, the "issue" class, which every instruction counts against.
DATA_SHEET_BYTES_PER_S = 3.35e12
SMS, BOOST_HZ = 132, 1.98e9
DATA_SHEET_OPS_PER_S = {
    "fp32": SMS * 128 * BOOST_HZ,
    "compare": SMS * 64 * BOOST_HZ,
    "sfu": SMS * 16 * BOOST_HZ,
    "conversion": SMS * 16 * BOOST_HZ,
    "int32": SMS * 64 * BOOST_HZ,
    "logic": SMS * 64 * BOOST_HZ,
    "lookup": SMS * 32 * BOOST_HZ,
    "issue": SMS * 4 * 32 * BOOST_HZ,
    "tensor_f16": 989e12,  # dense f16 tensor-core flops, not instructions
    "tensor_int8": 1979e12,  # dense int8 tensor-core operations (P1's one-hot mma), not instructions
    "shared_words": SMS * 32 * BOOST_HZ,  # 32-bit words of shared memory moved, not instructions
}
NOT_INSTRUCTIONS = ("tensor_f16", "tensor_int8", "shared_words")  # left out of the issue sum

# The SASS opcodes of each class, for the classes a float op's or Box-Muller's
# instructions are counted in (:func:`pipe_counts`). FSEL, a select on a
# predicate, has no row in the Guide: it goes with the compare that sets its
# predicate, as the second half of a compare-and-select (its own rate is not
# measured here); I2FP, Hopper's integer-to-float conversion, goes with the
# Guide's other conversions. Integer, predicate, move and branch
# instructions count in "issue" only.
PIPE_OPCODES = {
    "fp32": ("FFMA", "FADD", "FMUL"),
    "compare": ("FSETP", "FMNMX", "FSEL"),
    "sfu": ("MUFU",),
    "conversion": ("I2F", "I2FP", "F2I", "F2F", "FRND"),
    "lookup": ("LDS",),
}
# The integer loops' classes (P1's, as chip_smoke.py phase 22 counts them):
# integer compares and selects with the float ones (the Guide's row of
# compares, minimums and maximums), bitwise operations, shifts and byte
# permutes "logic", adds, multiply-adds and address arithmetic "int32", and,
# apart from any class of the data sheet, shuffles and tensor-core mma.
INTEGER_PIPE_OPCODES = {
    **PIPE_OPCODES,
    "compare": PIPE_OPCODES["compare"] + ("ISETP", "SEL"),
    "logic": ("LOP3", "SHF", "PRMT"),
    "int32": ("IADD3", "IMAD", "LEA"),
    "shuffle": ("SHFL",),
    "mma": ("IMMA", "HMMA"),
}
# One application of each float op of ops/float_ops.py as nvcc compiles it
# for sm_90a (csrc/float_groups.cuh, as K2 and K4 run it; box-plus takes
# CUDA's libm expf and log1pf, as torch's kernels call them, so K2 and K4
# equal their twins): SASS instructions per opcode of one trip of K5c's
# chain loop (csrc/peaks.cu float_pair_kernel<Op>) over the applications in
# it (1024 a trip; 256 for box-plus), the paths libm takes on finite inputs
# only, as built for an NVIDIA H100 80GB HBM3 (cuobjdump -sass;
# chip_smoke.py phase 16 counts them again): what the card runs, not the
# operations of the formula, which leave out libm's work.
FLOAT_OP_SASS = {
    "minsum_op": {"FSEL": 3.0, "FSETP": 2.0517578125, "FMUL": 2.0, "FMNMX": 1.0,
                  "P2R": 0.00390625, "ISETP": 0.00390625, "UIADD3": 0.0009765625,
                  "UISETP": 0.0009765625, "PLOP3": 0.0009765625, "BRA": 0.0009765625},
    "boxplus": {"FFMA": 30.0, "FADD": 10.0, "FMUL": 8.0, "IADD3": 6.0, "LOP3": 4.14453125,
                "FSEL": 3.0, "ISETP": 2.16796875, "FSETP": 2.125, "BRA": 2.00390625, "BSSY": 2.0,
                "SHF": 2.0, "MUFU": 2.0, "I2FP": 2.0, "BSYNC": 2.0, "FMNMX": 1.0, "P2R": 0.16796875,
                "HFMA2": 0.0078125, "MOV": 0.0078125, "UIADD3": 0.00390625, "UISETP": 0.00390625,
                "PLOP3": 0.00390625},
    "float_mix": {"FMNMX": 2.0, "FADD": 1.0, "UIADD3": 0.0009765625, "ISETP": 0.0009765625,
                  "BRA": 0.0009765625},  # add, then clip at +-150
    "min": {"FMNMX": 1.0, "UIADD3": 0.0009765625, "ISETP": 0.0009765625, "BRA": 0.0009765625},
}
MINSUM_OPS_PER_CN_EDGE = 4  # abs, min tracking, min1/min2 select, sign (cell_roofline's count)
MINSUM_OP_ALU_OPS = 7  # the operations of sign(a) sign(b) min(|a|, |b|) (cell_roofline's count)
# The min-sum decoders' float work per edge and body by class (decode_bound):
# a check edge's abs, min tracking, min1/min2 select and sign all compare or
# select; a variable edge's add into the total and subtract, and its clip at
# +-150 (a minimum and a maximum).
MINSUM_CN_OPS_PER_EDGE = {"compare": 4}
VN_OPS_PER_EDGE = {"fp32": 2, "compare": 2}
# The integer pipes' work of one Philox4x32-10 group (csrc/philox_planes.cu,
# sim/rng.py): ten rounds of two 32 x 32 -> 64-bit products, each a low and
# a high word, and two three-input XORs.
PHILOX_GROUP_OPS = {"int32": 40, "logic": 20}
# The integer work of one element-step of P1's column chain
# (kernels/lut_columns.py), besides building the column: the extract and
# the update (``acc += cols[0]``, ``b = (e + b) & (T1 - 1)``), by class:
# shifts and bitwise operations "logic", compares and selects "compare",
# adds and multiplies "int32". Two counts, and the bound takes the smaller
# in each class (COLUMN_STEP_OPS), so that it counts no more than either
# way of doing it needs. COLUMN_FORMULA_OPS counts ``extract``'s formula,
# once per distinct operation: the word select as a compare and a select
# per candidate word, the field's shifts and masks, split packing's high
# bit. COLUMN_SASS_OPS counts the CUDA-core kernels' loops as nvcc builds
# them for sm_90a (cuobjdump -sass; chip_smoke.py phase 22 counts them
# again, and holds every kernel's loop at or above COLUMN_STEP_OPS), per
# element-step, the loop's own counter and branch left out: at T1 = 32 the
# nibble word is chosen by two selects on two predicates and shifts and
# masks merge into LOP3, and IMAD also shifts, moves and addresses.
COLUMN_FORMULA_OPS = {
    16: {"logic": 5, "compare": 2, "int32": 3},
    32: {"logic": 10, "compare": 6, "int32": 3},
}
COLUMN_SASS_OPS = {
    16: {"logic": 5.125, "compare": 2, "int32": 7.125},
    32: {"logic": 6.5, "compare": 2, "int32": 5.5},
}
COLUMN_STEP_OPS = {
    t1: {k: min(n, COLUMN_SASS_OPS[t1][k]) for k, n in ops.items()}
    for t1, ops in COLUMN_FORMULA_OPS.items()
}
COPY_BYTES = 256 * 1024 * 1024  # one K6 buffer, five times the 50 MB L2


def ib_lookup_counts(layout: DecodeLayout, tables: TrellisTables, use_matching: bool = True) -> dict:
    """Lookups of one decode iteration per codeword, as K1 and K3 make them
    (``csrc/ib_lut_groups.cuh``): a check node of degree d makes
    (d-2)(d+3)/2 pairwise lookups and a variable node (d-1)(d+2)/2; with
    message alignment every output edge of both passes adds one 1-D remap,
    except at degree-1 variable nodes, which forward the channel. Keys are
    ``("lookup2d", T)`` and ``("lookup1d", T)``; a zero count is left out."""
    t = tables.cardinality_t_decoder
    n2 = sum(g.num_nodes * (g.degree - 2) * (g.degree + 3) // 2 for g in layout.cn_groups)
    n2 += sum(g.num_nodes * (g.degree - 1) * (g.degree + 2) // 2 for g in layout.vn_groups)
    n1 = 0
    if use_matching and tables.has_matching:
        n1 = sum(g.num_nodes * g.degree for g in layout.cn_groups)
        n1 += sum(g.num_nodes * g.degree for g in layout.vn_groups if g.degree > 1)
    counts = {("lookup2d", t): n2, ("lookup1d", t): n1}
    return {k: v for k, v in counts.items() if v}


def float_cn_applications(layout: DecodeLayout) -> int:
    """CN fold op applications per iteration per codeword: the prefix/suffix
    leave-one-out costs 3(d-2) applications per degree-d check node."""
    return sum(g.num_nodes * 3 * max(g.degree - 2, 0) for g in layout.cn_groups)


def cn_edges(layout: DecodeLayout) -> int:
    return sum(g.num_nodes * g.degree for g in layout.cn_groups if g.degree >= 2)


def view_bytes_per_body(
    layout: DecodeLayout, decoder: str, tables: TrellisTables | None = None
) -> float:
    """Device-memory traffic of one body per codeword of K3 (IB: both views
    read and written once and the channel plane read, at the bits a message
    that ``tables`` give K3, :func:`~..kernels.ib_lut_hbm.view_bits`) or K4,
    as the traffic bound counts it: on K4's node-state path
    (:func:`~..kernels.float_hbm.takes_node_state`) each check's 10-byte
    record read twice and written once and each variable's total and
    channel LLR (4 bytes each) read once and its total written once, else
    four float32 views an edge."""
    if decoder == "ib":
        bits = view_bits(tables.cardinality_t_channel, tables.cardinality_t_decoder)
        return (4 * layout.n_edges + layout.n_vars) * bits / 8
    if takes_node_state(layout, decoder):
        return 30 * layout.n_checks + 12 * layout.n_vars
    return 16 * layout.n_edges


def cell_roofline(
    layout: DecodeLayout,
    decoder: str,
    backend: str,
    i_eff: float,
    peak: Callable[..., float],
    bandwidth: float | None,
    tables: TrellisTables | None = None,
    use_matching: bool = True,
    achieved_bps: float = 0.0,
) -> dict:
    """The roofline entry of one cell: its bound, speed-of-light in coded
    Mbit/s and the fraction of it that ``achieved_bps`` reaches. ``peak``
    is ``primitive_peak`` (or a stand-in); ``bandwidth`` the copy bytes/s
    (:func:`traffic_bandwidth`), used when ``backend`` is 'hbm'."""
    i_eff = max(float(i_eff), 1.0)
    if decoder == "ib":
        counts = ib_lookup_counts(layout, tables, use_matching)
        rates = {k: lookup2d_peak(k[1], peak) if k[0] == "lookup2d" else peak(*k) for k in counts}
        t_iter = sum(n / rates[k] for k, n in counts.items())
        sol = layout.n_vars / (t_iter * i_eff)
        entry = {
            "bound": "lookup_primitives",
            "primitives_per_iteration_per_codeword": {
                "_".join(map(str, k)): int(n) for k, n in counts.items()
            },
        }
    elif decoder == "bp":
        apps = float_cn_applications(layout)
        sol = layout.n_vars * peak("boxplus") / (apps * i_eff)
        entry = {"bound": "cn_boxplus", "cn_op_applications_per_iteration_per_codeword": apps}
    else:
        edges = cn_edges(layout)
        alu_ops = MINSUM_OP_ALU_OPS * peak("minsum_op")
        sol = layout.n_vars * alu_ops / (MINSUM_OPS_PER_CN_EDGE * edges * i_eff)
        entry = {
            "bound": "cn_minsum_alu_floor",
            "cn_edges_per_iteration_per_codeword": edges,
            "min_ops_per_edge": MINSUM_OPS_PER_CN_EDGE,
        }
    if backend == "hbm":
        per_body = view_bytes_per_body(layout, decoder, tables)
        traffic_sol = bandwidth * layout.n_vars / (per_body * i_eff)
        if traffic_sol < sol:
            sol = traffic_sol
            entry["bound"] = "hbm_traffic"
        entry["view_bytes_per_body_per_codeword"] = per_body
        entry["hbm_traffic_sol_coded_mbps"] = traffic_sol / 1e6
    entry["speed_of_light_coded_mbps"] = sol / 1e6
    entry["achieved_coded_mbps"] = achieved_bps / 1e6
    entry["fraction_of_sol"] = achieved_bps / sol
    entry["i_eff"] = i_eff
    return entry


def _table_bytes(tables: TrellisTables) -> int:
    names = ("cn_iter0_first", "cn_iter0_rest", "cn_rest", "vn_first", "vn_rest")
    if tables.has_matching:
        names += ("matching_cn", "matching_vn")
    return sum(np.asarray(getattr(tables, n)).size for n in names)


def pipe_counts(opcodes: dict[str, float], table: dict = PIPE_OPCODES) -> dict[str, float]:
    """Instructions per class of ``table`` (:data:`PIPE_OPCODES`) in a
    count of SASS opcodes."""
    return {k: sum(opcodes.get(op, 0) for op in ops) for k, ops in table.items()}


def sass_counts(opcodes: dict[str, float], table: dict = PIPE_OPCODES) -> dict[str, float]:
    """:func:`pipe_counts` and, as "issue", every instruction of the count:
    the operations of a loop whose every instruction is the work."""
    counts = pipe_counts(opcodes, table)
    return {**{k: n for k, n in counts.items() if n}, "issue": sum(opcodes.values())}


# One application of each float op by class, from its SASS.
FLOAT_OP_COUNTS = {op: sass_counts(opcodes) for op, opcodes in FLOAT_OP_SASS.items()}
BOXPLUS_SASS = FLOAT_OP_COUNTS["boxplus"]


def channel_input_ops(
    kind: str, rows: int, batch: int, box_muller: dict[str, float], thresholds: int = 0
) -> dict[str, float]:
    """The operations by class (:data:`DATA_SHEET_OPS_PER_S`) that the
    [rows, batch] output of the channel-input ``kind`` (a plane or fused
    kind of ``kernels/philox_planes.py``) needs: its Philox groups
    (:data:`PHILOX_GROUP_OPS`); per element a uniform's conversion and
    scaling or a normal's Box-Muller, ``box_muller`` by class (the libdevice
    ``logf``, ``sqrtf`` and ``cosf`` its ``==`` requires, counted from its
    SASS by :func:`pipe_counts`); y's multiply and add; the true LLR's two
    multiplies; and a search over ``thresholds`` values of log2 of its
    outcomes in compares and shared-memory loads, one more load for the
    cluster's LLR. :func:`bound` adds their issue."""
    draw, consumer, _ = philox_planes.FUSED.get(kind, (kind, "plane", False))
    per = philox_planes.ELEMENTS_PER_GROUP[draw]
    groups = -(-rows // per) * batch
    ops = {k: n * groups for k, n in PHILOX_GROUP_OPS.items()}
    elements = rows * batch
    per_element = collections.Counter()
    if draw == "uniform":
        per_element.update(conversion=1, fp32=1)
    elif draw == "normal":
        per_element.update(box_muller)
        if consumer != "plane":
            per_element["fp32"] += 2
    if consumer == "true":
        per_element["fp32"] += 2
    elif consumer in ("clusters", "llrs"):
        probes = math.ceil(math.log2(thresholds + 1))
        per_element.update(compare=probes, lookup=probes + (consumer == "llrs"))
    for k, n in per_element.items():
        ops[k] = ops.get(k, 0) + n * elements
    return ops


def bound(moved: float, ops: dict[str, float]) -> dict:
    """The least time on an H100 SXM (data sheet) of moving ``moved`` bytes
    and doing ``ops`` operations (class -> count, the classes of
    :data:`DATA_SHEET_OPS_PER_S`): the larger of the bytes over the memory
    rate and the busiest class's count over its rate, named by ``bound_by``
    and ``busiest``. Every instruction also counts against the issue
    limit: "issue" is at least the sum of the other classes but those of
    :data:`NOT_INSTRUCTIONS` (a count of a loop's every instruction can give
    more)."""
    ops = {k: n for k, n in ops.items() if n}
    issued = sum(n for k, n in ops.items() if k != "issue" and k not in NOT_INSTRUCTIONS)
    if issued or "issue" in ops:
        ops["issue"] = max(ops.get("issue", 0.0), issued)
    io_ms = moved / DATA_SHEET_BYTES_PER_S * 1e3
    times = {k: n / DATA_SHEET_OPS_PER_S[k] * 1e3 for k, n in ops.items()}
    busiest = max(times, key=times.get, default=None)
    ops_ms = times[busiest] if busiest else 0.0
    return {
        "io_ms": io_ms,
        "compute_ms": ops_ms,
        "busiest": busiest,
        "bound_ms": max(io_ms, ops_ms),
        "bound_by": "bytes" if io_ms >= ops_ms else "operations",
    }


def decode_bound(
    layout: DecodeLayout,
    decoder: str,
    batch: int,
    bodies: float,
    tables: TrellisTables | None = None,
) -> dict:
    """The least time a decode of ``batch`` codewords running ``bodies``
    loop bodies each (the measured mean) could take on an H100 SXM
    (:func:`bound`): its input read once and outputs written once, and its
    operations by class: the IB decoder's table lookups; the float decoders'
    work per edge (:data:`MINSUM_CN_OPS_PER_EDGE`, :data:`VN_OPS_PER_EDGE`;
    box-plus as its SASS, :data:`BOXPLUS_SASS`) and the decision's sums,
    each instruction also against the issue limit."""
    per_cw = 4 * 2 * layout.n_vars + 8  # input, outputs, unsat and iterations
    if decoder == "ib":
        per_body = sum(ib_lookup_counts(layout, tables).values())
        cn_part = sum(g.num_nodes * (g.degree - 2) * (g.degree + 3) // 2 for g in layout.cn_groups)
        if tables.has_matching:
            cn_part += sum(g.num_nodes * g.degree for g in layout.cn_groups)
        ops = {"lookup": batch * (cn_part + bodies * per_body + layout.n_edges)}
        moved = batch * per_cw + _table_bytes(tables)
    else:
        per_body = collections.Counter({k: n * layout.n_edges for k, n in VN_OPS_PER_EDGE.items()})
        if decoder == "bp":
            apps = float_cn_applications(layout)
            vn_issue = sum(per_body.values())
            per_body.update({k: n * apps for k, n in BOXPLUS_SASS.items()})
            per_body["issue"] += vn_issue  # the box-plus count holds only its own
        else:
            per_body.update({k: n * cn_edges(layout) for k, n in MINSUM_CN_OPS_PER_EDGE.items()})
        ops = {k: float(batch * bodies * n) for k, n in per_body.items()}
        ops["fp32"] += batch * layout.n_edges  # the decision's sums
        if "issue" in ops:
            ops["issue"] += batch * layout.n_edges
        moved = batch * per_cw
    return {"bytes": int(moved), "ops": {k: float(n) for k, n in ops.items()}, **bound(moved, ops)}


def measure_hbm_bandwidth(device: torch.device | str = "cuda") -> float:
    """Device-memory copy bandwidth in bytes/s, read and write counted: K6
    copies one 256 MB buffer into another, L and 2L passes per launch, and
    the rate is the difference of the two times (``utils/peaks.py``)."""
    device = _cuda(device)
    src = torch.arange(COPY_BYTES // 4, dtype=torch.int32, device=device)
    dst = torch.empty_like(src)
    return differenced_rate(
        lambda n: hbm_copy.copy(src, dst, passes=n), 2 * COPY_BYTES, loops=1
    )


def measure_copy_bandwidth(device: torch.device | str = "cuda") -> float:
    """The same copy by ``torch``'s ``copy_``, L and 2L calls. The card
    moves bytes at least this fast, so the traffic bound takes the faster of
    this and K6 (:func:`traffic_bandwidth`)."""
    device = _cuda(device)
    src = torch.arange(COPY_BYTES // 4, dtype=torch.int32, device=device)
    dst = torch.empty_like(src)
    return differenced_rate(
        lambda n: [dst.copy_(src) for _ in range(n)], 2 * COPY_BYTES, loops=1
    )


def traffic_bandwidth(device: torch.device | str = "cuda") -> dict:
    """K6's and ``copy_``'s measured bandwidths (bytes/s) and the faster,
    ``bytes_per_s``, which the traffic bound divides by."""
    k6, copy = measure_hbm_bandwidth(device), measure_copy_bandwidth(device)
    return {"k6": k6, "copy_": copy, "bytes_per_s": max(k6, copy)}
