"""The probes P1-P6 on one CUDA card: rates beside their data-sheet bounds.

Port of the measurement halves of ``scripts/mxu_col_probe.py`` (P1),
``scripts/read_bw_probe.py`` (P2), ``scripts/read_bw_probe2.py`` (P3),
``scripts/dma_probe.py`` (P4), ``scripts/stage_probe.py`` (P5) and
``scripts/stage_replay.py`` (P6). Every rate is differenced between n and 2n
loops, passes, waves, iterations or bodies timed with CUDA events (``utils/peaks.py``
``differenced_rate``), n grown until one launch takes at least
:data:`MIN_SECONDS` (P2/P3: :data:`READ_MIN_SECONDS`), which cancels the
launch and set-up costs:

- P1 (:func:`measure_columns`): element-steps/s of the column-build chain on
  CUDA cores and on tensor cores at (T1, W) = (16, 2) and (32, 5), over the
  elements that fill the card, and the device ms of a 16-step launch they
  give; bound per pipe class (:func:`column_bound`): the column's W words
  of shared memory or the one-hot ``mma``'s int8 operations on its 4W
  bytes, and the extract's and update's integer work, every instruction
  (the loads, not the words) also against the issue limit; beside
  ``index_select``'s build of one step's columns;
- P2/P3 (:func:`measure_reads`): bytes/s read from a 256 MB source per
  variant and chunk size, and the device ms of one pass they give, beside
  ``x.sum()`` over the same source and, for the 7-plane variants, one sum
  over the 224 MB of planes they read (:func:`read_library`);
- P4 (:func:`measure_copies`): waves/s of each copy variant (the card-wide
  wave of 512 copies dealt over one block per SM; that wave on one block,
  one SM's issue cost; a wave on each of 132 blocks), as microseconds per
  copy and per wait and effective bytes/s, beside ``index_copy_`` of the
  same copies for the scatter and ``index_select`` and a sum of the same
  rows for the stage;
- P5 (:func:`measure_stage`): ms per simulated iteration of the staged
  7-plane skeleton and its staged bytes/s, per variant, against 293.6 MB at
  3.35 TB/s;
- P6 (:func:`measure_replay`): ms per body of the port's K3 pass program
  with the folds replaced, per variant, on DVB-S2 at batch 1024, its view
  bytes/s against the view traffic at 3.35 TB/s, beside K3's own ms per body
  (one decode, early exit off, over its bodies).

Bytes are bounded by the data sheet's 3.35 TB/s; a read or copy rate above
:data:`MAX_SHARE` of it means a byte count is wrong, and raises, but for a
P4 wave whose copies fit the L2 (:data:`L2_BYTES`): its waves after the
first write or read the same bytes, which need not leave the L2. There is
no CPU measurement: every function raises without a CUDA device.
"""

from __future__ import annotations

import torch

from ..construct.config import DecoderConfig
from ..kernels import bulk_copies as p4
from ..kernels import bulk_read as p23
from ..kernels import lut_columns as p1
from ..kernels import stage_chunks as p5
from ..kernels import stage_replay as p6
from ..kernels.ib_lut_hbm import HBMFusedIBDecoder
from ..models import get_model
from .benchmarks import CONFIG_DIR
from .peaks import _cuda, device_ms, differenced_rate
from . import roofline
from .roofline import DATA_SHEET_BYTES_PER_S

MIN_SECONDS = 0.1  # one launch at the final count takes at least this
READ_MIN_SECONDS = 0.05  # a read pass or sum takes 0.07-0.5 ms: a hundred or more a launch
MAX_SHARE = 1.05  # of the data sheet's bytes/s, above which a byte count is wrong
L2_BYTES = 50 * 2**20  # the H100's L2: a wave whose copies fit it repeats at L2 rates
P4_ROWS = (1, 32, 256)  # 512 B, 16 KB, 128 KB: the TPU probe's 1, 32, 256 rows
P4_GRID_ROWS = (1, 32)  # sizes also run as a wave on each of 132 blocks
P4_ENTRIES = (8, 2)  # copies per wait at 32 rows, besides a whole wave
REPLAY_MODEL, REPLAY_BATCH = "dvbs2-64800", 1024  # P6's code and batch: 8 tiles of K3's 128
REPLAY_CONFIG = "dvbs2_T16_0.6"  # K3's tables for its ms per body beside P6


def _bytes_rate_ok(rate: float, what: str) -> None:
    if rate > MAX_SHARE * DATA_SHEET_BYTES_PER_S:
        raise AssertionError(
            f"{what} reads {rate / 1e9:.1f} GB/s, above {MAX_SHARE} x the data sheet's "
            f"{DATA_SHEET_BYTES_PER_S / 1e9:.0f} GB/s: its byte count is wrong"
        )


def column_ops(variant: str, t1: int, steps: float) -> dict[str, float]:
    """The operations by class of ``steps`` element-steps of P1's chain:
    building the column (on CUDA cores its W words of shared memory, read by
    the loads its table's layout needs; on tensor cores the one-hot mma's
    int8 operations on its 4W bytes) and the extract's and update's integer
    work (:data:`roofline.COLUMN_STEP_OPS`)."""
    if variant == "cuda_cores":
        ops = {"shared_words": steps * p1.CONFIGS[t1][1], "lookup": steps * p1.CUDA_LOADS_PER_STEP[t1]}
    else:
        ops = {"tensor_int8": steps * p1.mma_flops_per_step(t1)}
    ops.update({k: n * steps for k, n in roofline.COLUMN_STEP_OPS[t1].items()})
    return ops


def column_bound(variant: str, t1: int) -> dict:
    """Element-steps/s of the data sheet per pipe class (:func:`column_ops`,
    :func:`roofline.bound`, every instruction also against the issue
    limit) and the class that binds."""
    b = roofline.bound(0, column_ops(variant, t1, 1))
    return {"per_s": 1e3 / b["compute_ms"], "busiest": b["busiest"]}


def column_library(packed: torch.Tensor, b: torch.Tensor):
    """The one PyTorch call that builds one step's columns of every element,
    ``packed.index_select(1, b)`` (the build alone, no extract), as a
    function of no arguments."""
    return lambda: packed.index_select(1, b)


def measure_columns(device: torch.device | str = "cuda") -> list[dict]:
    """P1 on every variant at both T1: element-steps/s differenced over steps
    in one launch, the device ms of a 16-step launch it gives, the per-pipe
    bound and its share, beside the library call's build of one step's
    columns (:func:`column_library`, its device time per call: one call
    takes a few microseconds, less than the host takes to launch it)."""
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
            library = elements / device_ms(column_library(packed, b0.long() & (t1 - 1))) * 1e3
            bound = column_bound(variant, t1)
            w = p1.CONFIGS[t1][1]
            ms = elements * 16 / rate * 1e3
            print(f"T1={t1} W={w} {variant}: {rate / 1e9:.2f} G col-builds/s, {ms:.5f} ms per "
                  f"16-step launch of {elements} elements; per-pipe bound {bound['per_s'] / 1e9:.2f} "
                  f"({bound['busiest']}), {rate / bound['per_s']:.1%}; index_select {library / 1e9:.2f} "
                  "G column builds/s (no extract)", flush=True)
            out.append({"name": p1.variant_name(variant, t1), "t1": t1, "w": w,
                        "elements": elements, "element_steps_per_s": rate, "ms_per_16_steps": ms,
                        "bound_per_s": bound["per_s"], "bound_class": bound["busiest"],
                        "library_element_steps_per_s": library,
                        "library_ms_per_16_steps": elements * 16 / library * 1e3})
    return out


def read_source(device: torch.device, seed: int = 0, rows: int = p23.SOURCE_ROWS) -> torch.Tensor:
    """A seeded int32 [rows, 128] source: by default the read probes' 256
    MB; P5 reads [591,872, 128] (303 MB)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return torch.randint(-2**31, 2**31 - 1, (rows, 128), dtype=torch.int32,
                         device=device, generator=g)


def read_label(variant: str) -> str:
    return {"seq": "streams=1", "strided": f"streams={p23.STREAMS}"}.get(variant, variant)


def read_library(probe: p23.BulkRead, src: torch.Tensor):
    """For a 7-plane variant (strided, table, nested), one PyTorch call that
    sums the words it reads, as a function of no arguments, and their bytes:
    the first ``chunks x L`` rows of each of the 7 planes (all of [0, 7
    rows/8) at 4 and 16 KB). Its wrapping total is that of the per-block
    checksums of one pass."""
    plane = probe.rows // 8
    rows = probe.units // p23.STREAMS * probe.chunk_rows
    planes = src[:p23.STREAMS * plane].view(p23.STREAMS, plane, -1)[:, :rows]
    return (lambda: planes.sum()), probe.bytes_per_pass


def measure_reads(probes: list[str], device: torch.device | str = "cuda") -> dict:
    """P2/P3: the read rate of every (variant, chunk) of ``probes`` ('p2',
    'p3'; shared variants run once), differenced over passes in one launch,
    and the ms of a pass it gives; ``x.sum()``'s rate over the source, and
    for the 7-plane variants their planes' sum's (:func:`read_library`)."""
    device = _cuda(device)
    src = read_source(device)
    variants = list(dict.fromkeys(v for p in probes for v in p23.PROBES[p]))
    out, library = {"variants": []}, {}  # variants that read the same bytes share a library rate
    for variant, kb in variants:
        probe = p23.BulkRead(variant, kb * 1024 // p23.ROW_BYTES)
        rate = differenced_rate(lambda n: probe(src, passes=n), probe.bytes_per_pass, loops=1,
                                min_seconds=READ_MIN_SECONDS)
        flight = probe.bytes_in_flight_per_sm()
        print(f"{read_label(variant)} chunk={kb} KB: {rate / 1e9:.1f} GB/s read "
              f"({rate / DATA_SHEET_BYTES_PER_S:.1%} of the data sheet's 3.35 TB/s), "
              f"{probe.bytes_per_pass / rate * 1e3:.4f} ms a pass; {probe.slots()} slots, "
              f"{flight // 1024} KB in flight per SM", flush=True)
        _bytes_rate_ok(rate, probe.name)
        rec = {"name": probe.name, "variant": variant, "chunk_kb": kb, "slots": probe.slots(),
               "bytes_in_flight_per_sm": flight, "bytes_per_pass": probe.bytes_per_pass,
               "bytes_per_s": rate, "ms_per_pass": probe.bytes_per_pass / rate * 1e3}
        if variant != "seq":
            call, moved = read_library(probe, src)
            if moved not in library:
                library[moved] = differenced_rate(lambda n: [call() for _ in range(n)], moved,
                                                  loops=1, min_seconds=READ_MIN_SECONDS)
                print(f"the sum of the 7 planes' {moved / 2**20:.1f} MB: "
                      f"{library[moved] / 1e9:.1f} GB/s read", flush=True)
            rec["library_bytes_per_s"] = library[moved]
        out["variants"].append(rec)
    rate = differenced_rate(lambda n: [src.sum() for _ in range(n)], src.numel() * 4, loops=1,
                            min_seconds=READ_MIN_SECONDS)
    print(f"x.sum() over the 256 MB source: {rate / 1e9:.1f} GB/s read", flush=True)
    _bytes_rate_ok(rate, "x.sum()")
    out["sum_bytes_per_s"] = rate
    return out


def copy_variants(sms: int) -> list[p4.BulkCopies]:
    """P4's variants: both directions at each size as the card-wide wave
    (dealt over ``sms`` blocks) and on one block (one SM's issue cost), at
    the smaller sizes as a wave on each of ``sms`` blocks, and at 16 KB on
    one block with fewer copies per wait."""
    out = []
    for direction in p4.DIRECTIONS:
        out += [p4.BulkCopies(direction, rows, blocks=sms, regions=1) for rows in P4_ROWS]
        out += [p4.BulkCopies(direction, rows) for rows in P4_ROWS]
        out += [p4.BulkCopies(direction, rows, blocks=sms) for rows in P4_GRID_ROWS]
        out += [p4.BulkCopies(direction, 32, entries=e) for e in P4_ENTRIES]
    return out


def copy_library(v: p4.BulkCopies, operands: tuple, device: torch.device):
    """The one PyTorch call that does a P4 variant's wave, as a function of
    no arguments, and the bytes it moves: ``index_copy_`` of the copies'
    image rows into the target for a scatter; ``index_select`` of the rows
    the copies read and their sum for a stage."""
    to, frm = (torch.as_tensor(a, device=device)
               for a in p4.scatter_rows(v.copy_dst, v.copy_smem, v.copy_rows))
    if v.direction == "scatter":
        image, target = operands
        rows = image.index_select(0, frm)
        return (lambda: target.index_copy_(0, to, rows)), rows.numel() * 4
    (source,) = operands
    return (lambda: source.index_select(0, to).sum(dtype=torch.int64)), len(to) * p4.ROW_BYTES


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
    variant, beside its library call's bytes/s (:func:`copy_library`)."""
    device = _cuda(device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    out, library = [], {}  # variants with the same copies share their library call's rate
    for v in copy_variants(sms):
        operands = copy_operands(v, device)
        run = v.scatter if v.direction == "scatter" else v.stage
        waves_per_s = differenced_rate(lambda n: run(*operands, waves=n), 1.0, loops=1,
                                       min_seconds=MIN_SECONDS)
        rate = waves_per_s * v.copies * v.copy_bytes
        rec = {"name": v.name, "direction": v.direction, "copy_bytes": v.copy_bytes,
               "blocks": v.blocks, "copies": v.copies, "entries": v.entries,
               "copies_per_wait": v.group, "waits_per_wave": v.waits_per_wave,
               "us_per_copy": 1e6 / (waves_per_s * v.copies),
               "us_per_wait": 1e6 / (waves_per_s * v.waits_per_wave), "bytes_per_s": rate}
        line = (f"{v.name}: {v.copies} copies on {v.blocks} blocks, at most {v.group} a wait: "
                f"{rec['us_per_copy']:.4f} us/copy, {rec['us_per_wait']:.4f} us/wait "
                f"({v.waits_per_wave} waits of one warp a wave), {rate / 1e9:.2f} GB/s effective")
        if v.copies * v.copy_bytes > L2_BYTES:
            _bytes_rate_ok(rate, v.name)
        else:
            line += " (its copies fit the L2)"
        call, moved = copy_library(v, operands, device)
        key = (v.direction, v.copy_rows, v.regions)
        if key not in library:
            library[key] = differenced_rate(lambda n: [call() for _ in range(n)], moved, loops=1,
                                            min_seconds=MIN_SECONDS)
        lib = library[key]
        rec["library_bytes_per_s"] = lib
        rec["library_us_per_wave"] = 1e6 * moved / lib
        line += (f" ({'index_copy_' if v.direction == 'scatter' else 'index_select + sum'} "
                 f"{lib / 1e9:.2f} GB/s, {rec['library_us_per_wave']:.2f} us a wave against "
                 f"{1e6 / waves_per_s:.2f})")
        print(line, flush=True)
        out.append(rec)
        del operands
    return out


def measure_stage(device: torch.device | str = "cuda") -> list[dict]:
    """P5: ms per iteration and staged bytes/s of every variant."""
    device = _cuda(device)
    src = read_source(device, rows=p5.HBM_ROWS)
    out = []
    for variant in p5.VARIANTS:
        probe = p5.StageChunks(variant)
        rate = differenced_rate(lambda n: probe(src, iters=n), probe.bytes_per_iteration, loops=1,
                                min_seconds=MIN_SECONDS)
        ms = probe.bytes_per_iteration / rate * 1e3
        bound_ms = probe.bytes_per_iteration / DATA_SHEET_BYTES_PER_S * 1e3
        print(f"{variant:8s}: {ms:.4f} ms/iter ({p5.N_CHUNKS} chunks), "
              f"{ms * 1e3 / p5.N_CHUNKS:.2f} us/chunk, stage-read {rate / 1e9:.1f} GB/s "
              f"({rate / DATA_SHEET_BYTES_PER_S:.1%} of the data sheet's 3.35 TB/s, bound "
              f"{bound_ms:.4f} ms; pieces of {probe.piece_rows} rows)", flush=True)
        _bytes_rate_ok(rate, f"P5 {variant}")
        out.append({"name": variant, "piece_rows": probe.piece_rows,
                    "bytes_per_iteration": probe.bytes_per_iteration, "ms_per_iteration": ms,
                    "bytes_per_s": rate, "bound_ms": bound_ms})
    return out


def k3_ms_per_body(layout, batch: int, device: torch.device) -> tuple[float, int]:
    """K3's ms per body on ``layout``: one decode of random clusters at
    ``batch``, early exit off, timed by CUDA events over 3 decodes after a
    warm-up, over its i_max - 1 bodies; and the bits a message of its views."""
    tables = DecoderConfig.load(str(CONFIG_DIR / f"{REPLAY_CONFIG}.npz")).tables
    dec = HBMFusedIBDecoder(layout, tables, early_exit=False)
    g = torch.Generator(device=device)
    g.manual_seed(0)
    clusters = torch.randint(0, tables.cardinality_t_channel, (layout.n_vars, batch),
                             dtype=torch.int32, device=device, generator=g)
    dec(clusters)
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        dec(clusters)
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / 3 / (dec.imax - 1), dec.view_bits


def measure_replay(device: torch.device | str = "cuda") -> dict:
    """P6: ms per body, view bytes/s and the fraction of the view-traffic
    bound of every variant, and K3's ms per body and view bits beside them
    (P6 replays byte views, so only K3 on bytes runs its memory pattern)."""
    device = _cuda(device)
    layout = get_model(REPLAY_MODEL).make_layout()
    views = p6.ReplayViews.random(layout, REPLAY_BATCH, device)
    out = {"model": REPLAY_MODEL, "batch": REPLAY_BATCH, "variants": []}
    for variant in p6.VARIANTS:
        probe = p6.StageReplay(layout, variant)
        moved = probe.bytes_per_body(REPLAY_BATCH)
        bodies_per_s = differenced_rate(lambda n: probe(views, bodies=n), 1.0, loops=1,
                                        min_seconds=MIN_SECONDS)
        rate, ms = moved * bodies_per_s, 1e3 / bodies_per_s
        bound_ms = moved / DATA_SHEET_BYTES_PER_S * 1e3
        print(f"{variant:8s}: {ms:.4f} ms/body, views {moved / 1e6:.0f} MB/body -> "
              f"{rate / 1e9:.1f} GB/s ({bound_ms / ms:.1%} of the view-traffic bound "
              f"{bound_ms:.4f} ms)", flush=True)
        _bytes_rate_ok(rate, f"P6 {variant}")
        out["variants"].append({"name": variant, "tpu_variant": p6.TPU_VARIANT[variant],
                                "bytes_per_body": moved, "ms_per_body": ms, "bytes_per_s": rate,
                                "bound_ms": bound_ms})
    del views
    out["k3_ms_per_body"], out["k3_view_bits"] = k3_ms_per_body(layout, REPLAY_BATCH, device)
    print(f"K3 ({REPLAY_CONFIG}, early exit off, {out['k3_view_bits']}-bit views): "
          f"{out['k3_ms_per_body']:.4f} ms/body", flush=True)
    return out
