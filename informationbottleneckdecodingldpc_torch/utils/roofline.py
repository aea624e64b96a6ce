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
  body of the kernel that runs (K3: both uint8 views read and written and the
  channel plane read, 4 n_edges + n_vars; K4: 16 n_edges, as ``:440``
  counts the float32 views) over the copy bandwidth.

Every bound takes the measured mean iteration count as i_eff.

:func:`decode_bound` is the other bound, the one a kernel's record states:
the larger of the bytes the decode must move (its input read once, its
outputs written once) over the data sheet's memory rate and the operations
it does, each type over its own data-sheet rate (:data:`DATA_SHEET_OPS_PER_S`;
:func:`bound` does the arithmetic for any kernel).
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
from .peaks import _cuda, differenced_rate, lookup2d_peak

# NVIDIA H100 SXM data sheet: 132 SMs at a 1.98 GHz boost clock and device
# memory at 3.35 TB/s. Per SM and clock it issues 128 FP32 instructions (the
# data sheet's 67 TFLOP/s count an FMA as two operations), 32 shared-memory
# loads (one warp's: a table lookup each) and 16 special-function operations.
DATA_SHEET_BYTES_PER_S = 3.35e12
SMS, BOOST_HZ = 132, 1.98e9
DATA_SHEET_OPS_PER_S = {
    "fp32": SMS * 128 * BOOST_HZ,
    "lookup": SMS * 32 * BOOST_HZ,
    "sfu": SMS * 16 * BOOST_HZ,
    "tensor_f16": 989e12,  # dense f16 tensor-core flops (P1's one-hot mma)
}

MINSUM_OPS_PER_CN_EDGE = 4  # abs, min tracking, min1/min2 select, sign
MINSUM_OP_ALU_OPS = 7  # the operations of sign(a) sign(b) min(|a|, |b|)
# One box-plus as nvcc compiles it for sm_90a (csrc/float_groups.cuh
# boxplus: CUDA's libm expf and log1pf, as torch's kernels call them, so K2
# and K4 equal their twins): the FP32-pipe instructions (float add,
# multiply, fused multiply-add, compare, select and min/max; integer and
# branch instructions are left out) and special-function (MUFU)
# instructions it runs on finite inputs. Counted by cuobjdump -sass of K5c's
# box-plus chain loop (csrc/peaks.cu float_pair_kernel<BoxPlus>: 256
# box-plus a trip, 54.125 and 2 each, 78.6 instructions in all) as built
# for an NVIDIA H100 80GB HBM3; chip_smoke.py phase 16 counts them again. The elementwise reading, 19 operations and 2 exponentials, left
# K5c's chain at 15.6% of its bound.
FP32_OPCODES = ("FFMA", "FADD", "FMUL", "FSETP", "FSEL", "FMNMX")
SFU_OPCODES = ("MUFU",)
BOXPLUS_SASS = {"fp32": 54, "sfu": 2}
# One application of each float op of ops/float_ops.py, by operation type.
FLOAT_OP_COUNTS = {
    "minsum_op": {"fp32": MINSUM_OP_ALU_OPS},
    "boxplus": BOXPLUS_SASS,
    "float_mix": {"fp32": 3},  # add, then clip at +-150
    "min": {"fp32": 1},
}
# The integer pipes, per SM and clock (CUDA C++ Programming Guide,
# arithmetic instruction throughput, compute capability 9.0): 32-bit
# multiply (64) and 32-bit logic (64).
DATA_SHEET_OPS_PER_S.update(int32=SMS * 64 * BOOST_HZ, logic=SMS * 64 * BOOST_HZ)
# One Philox4x32-10 group (csrc/philox_planes.cu, sim/rng.py): ten rounds of
# two 32 x 32 -> 64-bit products, each a low and a high word, and two
# three-input XORs.
PHILOX_GROUP_OPS = {"int32": 40, "logic": 20}
# The SASS opcodes counted per operation type in a channel-input kernel's
# instructions (chip_smoke.py phase 25): the FP32 pipe, the special-function
# unit and shared-memory loads.
PIPE_OPCODES = {"fp32": FP32_OPCODES, "sfu": SFU_OPCODES, "lookup": ("LDS",)}
VN_OPS_PER_EDGE = 4  # add into the total, subtract, clip (two)
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


def view_bytes_per_body(layout: DecodeLayout, decoder: str) -> int:
    """Device-memory view traffic of one body per codeword of K3 (IB) or K4
    (float), as the traffic bound counts it."""
    if decoder == "ib":
        return 4 * layout.n_edges + layout.n_vars
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
        per_body = view_bytes_per_body(layout, decoder)
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


def pipe_counts(opcodes: dict[str, int]) -> dict[str, int]:
    """Instructions per type of :data:`PIPE_OPCODES` in a count of SASS
    opcodes."""
    return {k: sum(opcodes.get(op, 0) for op in ops) for k, ops in PIPE_OPCODES.items()}


def channel_input_ops(
    kind: str, rows: int, batch: int, box_muller: dict[str, float], thresholds: int = 0
) -> dict[str, float]:
    """The operations by type (:data:`DATA_SHEET_OPS_PER_S`) that the
    [rows, batch] output of the channel-input ``kind`` (a plane or fused
    kind of ``kernels/philox_planes.py``) needs: its Philox groups
    (:data:`PHILOX_GROUP_OPS`); per element a uniform's scaling or a normal's
    Box-Muller, ``box_muller`` by type (the libdevice ``logf``, ``sqrtf`` and
    ``cosf`` its ``==`` requires, counted from its SASS); y's multiply and
    add; the true LLR's two multiplies; and a search over ``thresholds``
    values of log2 of its outcomes in compares and shared-memory loads, one
    more load for the cluster's LLR."""
    draw, consumer, _ = philox_planes.FUSED.get(kind, (kind, "plane", False))
    per = philox_planes.ELEMENTS_PER_GROUP[draw]
    groups = -(-rows // per) * batch
    ops = {k: n * groups for k, n in PHILOX_GROUP_OPS.items()}
    elements = rows * batch
    per_element = collections.Counter()
    if draw == "uniform":
        per_element["fp32"] += 1
    elif draw == "normal":
        per_element.update(box_muller)
        if consumer != "plane":
            per_element["fp32"] += 2
    if consumer == "true":
        per_element["fp32"] += 2
    elif consumer in ("clusters", "llrs"):
        probes = math.ceil(math.log2(thresholds + 1))
        per_element.update(fp32=probes, lookup=probes + (consumer == "llrs"))
    for k, n in per_element.items():
        ops[k] = ops.get(k, 0) + n * elements
    return ops


def bound(moved: float, ops: dict[str, float]) -> dict:
    """The least time on an H100 SXM (data sheet) of moving ``moved`` bytes
    and doing ``ops`` operations (type -> count, the types of
    :data:`DATA_SHEET_OPS_PER_S`): the larger of the bytes over the memory
    rate and the busiest type's count over its rate, named by ``bound_by``."""
    io_ms = moved / DATA_SHEET_BYTES_PER_S * 1e3
    ops_ms = max((n / DATA_SHEET_OPS_PER_S[k] for k, n in ops.items()), default=0.0) * 1e3
    return {
        "io_ms": io_ms,
        "compute_ms": ops_ms,
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
    operations: the IB decoder's table lookups, the float decoders' FP32
    operations and box-plus's exponentials."""
    per_cw = 4 * 2 * layout.n_vars + 8  # input, outputs, unsat and iterations
    if decoder == "ib":
        per_body = sum(ib_lookup_counts(layout, tables).values())
        cn_part = sum(g.num_nodes * (g.degree - 2) * (g.degree + 3) // 2 for g in layout.cn_groups)
        if tables.has_matching:
            cn_part += sum(g.num_nodes * g.degree for g in layout.cn_groups)
        ops = {"lookup": batch * (cn_part + bodies * per_body + layout.n_edges)}
        moved = batch * per_cw + _table_bytes(tables)
    else:
        sfu = 0.0
        if decoder == "bp":
            apps = float_cn_applications(layout)
            cn_ops = FLOAT_OP_COUNTS["boxplus"]["fp32"] * apps
            sfu = batch * bodies * FLOAT_OP_COUNTS["boxplus"]["sfu"] * apps
        else:
            cn_ops = MINSUM_OPS_PER_CN_EDGE * cn_edges(layout)
        fp32 = batch * (bodies * (cn_ops + VN_OPS_PER_EDGE * layout.n_edges) + layout.n_edges)
        ops = {"fp32": fp32, "sfu": sfu}
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
