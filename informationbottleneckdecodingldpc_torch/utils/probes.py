"""The probes P1-P4 on one CUDA card: rates beside their data-sheet bounds.

Port of the measurement halves of ``scripts/mxu_col_probe.py`` (P1),
``scripts/read_bw_probe.py`` (P2), ``scripts/read_bw_probe2.py`` (P3) and
``scripts/dma_probe.py`` (P4). Every rate is differenced between n and 2n
loops, passes or waves timed with CUDA events (``utils/peaks.py``
``differenced_rate``), n grown until one launch takes at least
:data:`MIN_SECONDS`, which cancels the launch and set-up costs:

- P1 (:func:`measure_columns`): element-steps/s of the column-build chain on
  CUDA cores and on tensor cores at (T1, W) = (16, 2) and (32, 5), over the
  elements that fill the card; bounds: W shared-memory lookups per step at
  the data sheet's lookup rate, and the padded one-hot ``mma`` flops per
  step at its f16 tensor-core rate;
- P2/P3 (:func:`measure_reads`): bytes/s read from a 256 MB source per
  variant and chunk size, beside ``x.sum()`` over the same source;
- P4 (:func:`measure_copies`): waves/s of each copy variant, as
  microseconds per copy and per wait and effective bytes/s, beside
  ``index_copy_`` for the scatter.

Bytes are bounded by the data sheet's 3.35 TB/s; a read or copy rate above
:data:`MAX_SHARE` of it means a byte count is wrong, and raises. There is no
CPU measurement: every function raises without a CUDA device.
"""

from __future__ import annotations

import torch

from ..kernels import bulk_copies as p4
from ..kernels import bulk_read as p23
from ..kernels import lut_columns as p1
from .peaks import _cuda, differenced_rate
from .roofline import DATA_SHEET_BYTES_PER_S, DATA_SHEET_OPS_PER_S

MIN_SECONDS = 0.1  # one launch at the final count takes at least this
MAX_SHARE = 1.05  # of the data sheet's bytes/s, above which a byte count is wrong
P4_ROWS = (1, 32, 256)  # 512 B, 16 KB, 128 KB: the TPU probe's 1, 32, 256 rows
P4_GRID_ROWS = (1, 32)  # sizes also run on one block per SM
P4_ENTRIES = (8, 2)  # copies per wait at 32 rows, besides a whole wave


def _bytes_rate_ok(rate: float, what: str) -> None:
    if rate > MAX_SHARE * DATA_SHEET_BYTES_PER_S:
        raise AssertionError(
            f"{what} reads {rate / 1e9:.1f} GB/s, above {MAX_SHARE} x the data sheet's "
            f"{DATA_SHEET_BYTES_PER_S / 1e9:.0f} GB/s: its byte count is wrong"
        )


def column_bound(variant: str, t1: int) -> float:
    """Element-steps/s of the data sheet: W lookups per step on CUDA cores,
    the padded one-hot mma flops per step on tensor cores."""
    if variant == "cuda_cores":
        return DATA_SHEET_OPS_PER_S["lookup"] / p1.CONFIGS[t1][1]
    return DATA_SHEET_OPS_PER_S["tensor_f16"] / p1.mma_flops_per_step(t1)


def measure_columns(device: torch.device | str = "cuda") -> list[dict]:
    """P1 on every variant at both T1."""
    device = _cuda(device)
    out = []
    for t1 in p1.CONFIGS:
        for variant in p1.VARIANTS:
            elements = p1.elements_to_fill(variant, t1, device)
            packed, b0 = (torch.as_tensor(a, device=device) for a in p1.probe_inputs(t1, elements))
            rate = differenced_rate(
                lambda n: p1.columns_chain(variant, packed, b0, n), elements, loops=16,
                min_seconds=MIN_SECONDS,
            )
            bound = column_bound(variant, t1)
            w = p1.CONFIGS[t1][1]
            print(f"T1={t1} W={w} {variant}: {rate / 1e9:.2f} G col-builds/s, data-sheet bound "
                  f"{bound / 1e9:.2f} ({rate / bound:.1%})", flush=True)
            out.append({"name": p1.variant_name(variant, t1), "t1": t1, "w": w,
                        "elements": elements, "element_steps_per_s": rate, "bound_per_s": bound})
    return out


def read_source(device: torch.device, seed: int = 0) -> torch.Tensor:
    """The 256 MB int32 [1 << 19, 128] source of the read probes, seeded."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return torch.randint(-2**31, 2**31 - 1, (p23.SOURCE_ROWS, 128), dtype=torch.int32,
                         device=device, generator=g)


def read_label(variant: str) -> str:
    return {"seq": "streams=1", "strided": f"streams={p23.STREAMS}"}.get(variant, variant)


def measure_reads(probes: list[str], device: torch.device | str = "cuda") -> dict:
    """P2/P3: the read rate of every (variant, chunk) of ``probes`` ('p2',
    'p3'; shared variants run once), and ``x.sum()``'s over the source."""
    device = _cuda(device)
    src = read_source(device)
    variants = list(dict.fromkeys(v for p in probes for v in p23.PROBES[p]))
    out = {"variants": []}
    for variant, kb in variants:
        probe = p23.BulkRead(variant, kb * 1024 // p23.ROW_BYTES)
        rate = differenced_rate(lambda n: probe(src, passes=n), probe.bytes_per_pass, loops=1,
                                min_seconds=MIN_SECONDS)
        print(f"{read_label(variant)} chunk={kb} KB: {rate / 1e9:.1f} GB/s read "
              f"({rate / DATA_SHEET_BYTES_PER_S:.1%} of the data sheet's 3.35 TB/s)", flush=True)
        _bytes_rate_ok(rate, probe.name)
        out["variants"].append({"name": probe.name, "variant": variant, "chunk_kb": kb,
                                "bytes_per_pass": probe.bytes_per_pass, "bytes_per_s": rate})
    rate = differenced_rate(lambda n: [src.sum() for _ in range(n)], src.numel() * 4, loops=1,
                            min_seconds=MIN_SECONDS)
    print(f"x.sum() over the 256 MB source: {rate / 1e9:.1f} GB/s read", flush=True)
    _bytes_rate_ok(rate, "x.sum()")
    out["sum_bytes_per_s"] = rate
    return out


def copy_variants(sms: int) -> list[p4.BulkCopies]:
    """P4's variants: both directions at each size on one block, at the
    smaller sizes on ``sms`` blocks, and at 16 KB with fewer copies per
    wait."""
    out = []
    for direction in p4.DIRECTIONS:
        out += [p4.BulkCopies(direction, rows) for rows in P4_ROWS]
        out += [p4.BulkCopies(direction, rows, blocks=sms) for rows in P4_GRID_ROWS]
        out += [p4.BulkCopies(direction, 32, entries=e) for e in P4_ENTRIES]
    return out


def copy_operands(v: p4.BulkCopies, device: torch.device, seed: int = 0) -> tuple:
    """Seeded operands of a P4 variant: (image, zeroed target) for a
    scatter, (source,) for a stage."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)

    def draw(rows: int) -> torch.Tensor:
        return torch.randint(-2**31, 2**31 - 1, (rows, 128), dtype=torch.int32, device=device,
                             generator=g)

    if v.direction == "scatter":
        return draw(v.region_rows), torch.zeros((v.target_rows, 128), dtype=torch.int32, device=device)
    return (draw(v.target_rows),)


def measure_copies(device: torch.device | str = "cuda") -> list[dict]:
    """P4: per-copy and per-wait microseconds and effective bytes/s of every
    variant, beside ``index_copy_``'s bytes/s for the scatter."""
    device = _cuda(device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    out = []
    for v in copy_variants(sms):
        operands = copy_operands(v, device)
        run = v.scatter if v.direction == "scatter" else v.stage
        waves_per_s = differenced_rate(lambda n: run(*operands, waves=n), 1.0, loops=1,
                                       min_seconds=MIN_SECONDS)
        rate = waves_per_s * v.blocks * v.wave * v.copy_bytes
        rec = {"name": v.name, "direction": v.direction, "copy_bytes": v.copy_bytes,
               "blocks": v.blocks, "entries": v.entries, "copies_per_wait": v.group,
               "us_per_copy": 1e6 / (waves_per_s * v.wave),
               "us_per_wait": 1e6 / (waves_per_s * v.waits_per_wave), "bytes_per_s": rate}
        line = (f"{v.direction} L={v.name.split('_')[1]} blocks={v.blocks} copies/wait={v.group}: "
                f"{rec['us_per_copy']:.4f} us/copy, {rec['us_per_wait']:.4f} us/wait, "
                f"{rate / 1e9:.2f} GB/s effective")
        _bytes_rate_ok(rate, v.name)
        if v.direction == "scatter":
            image, target = operands
            to, frm = (torch.as_tensor(a, device=device) for a in p4.scatter_rows(v.dst, v.smem, v.copy_rows))
            rows = image.index_select(0, frm)
            lib = differenced_rate(lambda n: [target.index_copy_(0, to, rows) for _ in range(n)],
                                   rows.numel() * 4, loops=1, min_seconds=MIN_SECONDS)
            rec["index_copy_bytes_per_s"] = lib
            line += f" (index_copy_ {lib / 1e9:.2f} GB/s)"
        print(line, flush=True)
        out.append(rec)
        del operands
    return out

