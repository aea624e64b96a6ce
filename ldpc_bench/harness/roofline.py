"""The least time a decode could take on an H100 SXM, from the work it needs.

A frozen copy of the port's ``decode_bound`` arithmetic (its IB and
min-sum rows), counted from the configuration's graph and tables so that
the yardstick does not move when the program does:

- bytes: each codeword's input read once and its outputs written once (4
  bytes each way a variable, 8 more for its unsatisfied count and
  iterations), plus the decoder's tables once;
- IB operations, table lookups: a check node of degree d makes
  (d - 2)(d + 3) / 2 pairwise lookups a pass and a variable node
  (d - 1)(d + 2) / 2; with message alignment each output of a check and of
  a variable of degree above 1 one more; the first check pass, the
  ``bodies`` loop bodies (the run's own mean) and the decision (one lookup
  an edge);
- min-sum operations: 4 compares a check edge, 2 adds and 2 compares a
  variable edge, each body; the decision's adds, one an edge;
- rates: the data sheet's 3.35 TB/s and, per SM and clock on 132 SMs at
  1.98 GHz, 32 shared-memory lookups, 64 compares, 128 float adds; every
  instruction also counts against the issue limit of 128 a clock.

The bound is the larger of the bytes' time and the busiest class's time.
"""

from __future__ import annotations

BYTES_PER_S = 3.35e12
SMS, CLOCK_HZ = 132, 1.98e9
OPS_PER_S = {
    "lookup": SMS * 32 * CLOCK_HZ,
    "compare": SMS * 64 * CLOCK_HZ,
    "fp32": SMS * 128 * CLOCK_HZ,
    "issue": SMS * 128 * CLOCK_HZ,
}
TABLE_KEYS = ("cn_iter0_first", "cn_iter0_rest", "cn_rest", "vn_first", "vn_rest")
MATCHING_KEYS = ("matching_cn", "matching_vn")


def ib_lookups(check_degrees: dict, var_degrees: dict, alignment: bool) -> tuple[int, int]:
    """(lookups of one body, lookups of the first check pass) a codeword;
    the degree maps give the nodes of each degree."""
    cn = sum(n * (d - 2) * (d + 3) // 2 for d, n in check_degrees.items())
    vn = sum(n * (d - 1) * (d + 2) // 2 for d, n in var_degrees.items())
    cn_align = sum(n * d for d, n in check_degrees.items()) if alignment else 0
    vn_align = sum(n * d for d, n in var_degrees.items() if d > 1) if alignment else 0
    return cn + vn + cn_align + vn_align, cn + cn_align


def decode_ops(decoder: str, check_degrees: dict, var_degrees: dict, batch: int, bodies: float,
               alignment: bool = True) -> dict:
    """The operations by class of one decode of ``batch`` codewords."""
    edges = sum(n * d for d, n in var_degrees.items())
    if decoder == "ib":
        per_body, first = ib_lookups(check_degrees, var_degrees, alignment)
        return {"lookup": batch * (first + bodies * per_body + edges)}
    if decoder == "minsum":
        check_edges = sum(n * d for d, n in check_degrees.items() if d >= 2)
        return {"compare": float(batch * bodies * (4 * check_edges + 2 * edges)),
                "fp32": float(batch * bodies * 2 * edges + batch * edges)}
    raise ValueError(f"no operation count for decoder {decoder!r}")


def decode_bytes(n_vars: int, batch: int, table_elements: int) -> int:
    """Bytes one decode must move: inputs, outputs and the tables once."""
    return batch * (4 * 2 * n_vars + 8) + table_elements


def table_elements(tables: dict, alignment: bool) -> int:
    """Entries of the decoder's tables (a byte each)."""
    keys = TABLE_KEYS + (MATCHING_KEYS if alignment and "matching_cn" in tables else ())
    return sum(int(tables[k].size) for k in keys)


def bound_ms(moved: float, ops: dict) -> dict:
    """The least time in ms of moving ``moved`` bytes and doing ``ops``."""
    ops = {k: float(n) for k, n in ops.items() if n}
    ops["issue"] = sum(ops.values())
    io = moved / BYTES_PER_S * 1e3
    times = {k: n / OPS_PER_S[k] * 1e3 for k, n in ops.items()}
    busiest = max(times, key=times.get)
    return {"bound_ms": max(io, times[busiest]), "io_ms": io, "compute_ms": times[busiest],
            "busiest": busiest, "bound_by": "bytes" if io >= times[busiest] else "operations",
            "bytes": moved, "ops": ops}
