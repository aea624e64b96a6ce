"""The probes P1-P4 of the PyTorch port against the JAX probe scripts.

The scripts (``scripts/mxu_col_probe.py``, ``read_bw_probe.py``,
``read_bw_probe2.py``, ``dma_probe.py``) are loaded unedited with
``importlib``; their Pallas kernels run in interpret mode (the module's
``pl`` is swapped for a namespace whose ``pallas_call`` interprets) at sizes
shrunk through their module globals:

- P1: the plain column-build chain equals ``vpu_variant`` and
  ``mxu_variant`` bit for bit on the scripts' own inputs, at both packings;
- P2/P3: with a source of distinct rows (the module's ``jnp.zeros`` swapped
  for an ``arange``), the rows the script's slot 0 holds last are the rows
  ``read_schedule`` puts last into slot 0, and its byte count is the
  schedule's; the card's ring (sized by bytes, not the TPU's 4 slots) fits
  a block's shared memory with the table share it stages, which lists the
  rows the block reads, and the library call sums the words a variant
  reads;
- P4: the rows the stage direction leaves in slot 0 are those the port's
  tables send there last, and ``build_tiny_loops``' loop count is the port's
  waits per wave with the TPU's one issuer; the card-wide deal of a wave
  over blocks and warps issues every copy once;
- the plain checksums and the scatter against numpy loops; the wrappers'
  refusals and the entry point's refusal of the CPU.
"""

import functools
import importlib.util
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from informationbottleneckdecodingldpc_torch.cli import probes as cli_probes
from informationbottleneckdecodingldpc_torch.kernels import bulk_copies as p4
from informationbottleneckdecodingldpc_torch.kernels import bulk_read as p23
from informationbottleneckdecodingldpc_torch.kernels import lut_columns as p1
from informationbottleneckdecodingldpc_torch.utils import probes, roofline

REPO = Path(__file__).resolve().parents[1]
INTERPRET_PL = types.SimpleNamespace(
    **{k: getattr(pl, k) for k in dir(pl) if not k.startswith("__")},
)
INTERPRET_PL.pallas_call = functools.partial(pl.pallas_call, interpret=True)


class DistinctZeros:
    """``jax.numpy`` whose ``zeros`` gives distinct values (an ``arange``),
    so the rows of a probe's source can be told apart."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def zeros(shape, dtype=jnp.float32):
        shape = (shape,) if isinstance(shape, int) else tuple(shape)
        return jnp.arange(int(np.prod(shape)), dtype=dtype).reshape(shape)


def load_script(name, monkeypatch, **globals_):
    """``scripts/<name>.py``, unedited, with interpreting Pallas and the
    given module globals replaced."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    monkeypatch.setattr(module, "pl", INTERPRET_PL)
    for key, value in globals_.items():
        monkeypatch.setattr(module, key, value)
    return module


def source_rows(rows):
    """The distinct-valued source ``DistinctZeros`` gives a probe."""
    return np.arange(rows * 128, dtype=np.int32).reshape(rows, 128)


def last_rows_in_slot(schedule, slot=0):
    return int(schedule[schedule[:, 1] == slot][-1, 0])


# -- P1 ---------------------------------------------------------------------------

@pytest.mark.parametrize("loops", [1, 3])
@pytest.mark.parametrize("t1,fb,w", [(16, 4, 2), (32, 5, 5)])
@pytest.mark.parametrize("variant", ["vpu", "mxu"])
def test_column_chain_equals_the_jax_probe(monkeypatch, variant, t1, fb, w, loops):
    rows = 8
    script = load_script("mxu_col_probe", monkeypatch, ROWS=rows)
    build = script.vpu_variant if variant == "vpu" else script.mxu_variant
    want = np.asarray(build(t1, fb, w)(loops)())
    # The script's own inputs, drawn as it draws them.
    if variant == "vpu":
        packed = np.random.default_rng(2).integers(0, 2**31, (w, t1))
        b0 = np.random.default_rng(3).integers(0, t1, (rows, 128))
    else:
        packed, b0 = p1.probe_inputs(t1, rows * 128)
        b0 = b0.reshape(rows, 128)
    assert (fb, w) == p1.CONFIGS[t1]
    got = p1.columns_chain_plain(
        torch.as_tensor(packed.astype(np.int32)), torch.as_tensor(b0.astype(np.int32)), loops
    )
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


def test_column_chain_wrapper_runs_the_plain_version_on_the_cpu():
    packed, b0 = (torch.as_tensor(a) for a in p1.probe_inputs(32, 1024, seed=5))
    for variant in p1.VARIANTS:
        got = p1.columns_chain(variant, packed, b0, 4)
        assert torch.equal(got, p1.columns_chain_plain(packed, b0, 4))
    assert sum(p1.launches.values()) == 0
    # b0 is taken mod T1, on both paths.
    assert torch.equal(p1.columns_chain_plain(packed, b0 + 64, 2), p1.columns_chain_plain(packed, b0, 2))


def test_column_bounds_follow_the_data_sheet():
    assert roofline.DATA_SHEET_OPS_PER_S["tensor_f16"] == 989e12
    assert p1.mma_flops_per_step(16) == 2 * 16 * 8 and p1.mma_flops_per_step(32) == 2 * 32 * 24
    assert probes.column_bound("cuda_cores", 16) == pytest.approx(4.18e12, rel=5e-3)
    assert probes.column_bound("tensor_cores", 16) == pytest.approx(3.86e12, rel=5e-3)
    assert probes.column_bound("cuda_cores", 32) == pytest.approx(1.67e12, rel=5e-3)
    assert probes.column_bound("tensor_cores", 32) == pytest.approx(0.644e12, rel=5e-3)


# -- P2 / P3 ----------------------------------------------------------------------

READ_ROWS, READ_L = 1 << 10, 16


@pytest.mark.parametrize("streams,variant", [(1, "seq"), (7, "strided")])
def test_read_schedule_matches_read_bw_probe(monkeypatch, streams, variant):
    script = load_script("read_bw_probe", monkeypatch, ROWS=READ_ROWS, PLANE=READ_ROWS // 8,
                         jnp=DistinctZeros())
    fn, vol = script.build(READ_L, streams, 1)
    probe = p23.BulkRead(variant, READ_L, rows=READ_ROWS)
    first = last_rows_in_slot(probe.schedule)
    assert np.array_equal(np.asarray(fn()), source_rows(READ_ROWS)[first:first + 8])
    assert vol == probe.bytes_per_pass


@pytest.mark.parametrize("jax_variant,variant", [("seq", "seq"), ("smem", "table"), ("nested", "nested")])
def test_read_schedule_matches_read_bw_probe2(monkeypatch, jax_variant, variant):
    script = load_script("read_bw_probe2", monkeypatch, ROWS=READ_ROWS, PLANE=READ_ROWS // 8,
                         jnp=DistinctZeros())
    fn, vol = script.build(jax_variant, READ_L, 1)
    probe = p23.BulkRead(variant, READ_L, rows=READ_ROWS)
    first = last_rows_in_slot(probe.schedule)
    assert np.array_equal(np.asarray(fn()), source_rows(READ_ROWS)[first:first + 8])
    assert vol == probe.bytes_per_pass


@pytest.mark.parametrize("variant", p23.VARIANTS)
@pytest.mark.parametrize("chunk_rows", [16, 24])
def test_read_checksums_plain_match_a_numpy_loop(variant, chunk_rows):
    rng = np.random.default_rng(11)
    src = rng.integers(-2**31, 2**31, (READ_ROWS, 128)).astype(np.int32)
    probe = p23.BulkRead(variant, chunk_rows, rows=READ_ROWS)
    blocks, passes = 3, 2
    want = np.zeros(blocks, np.int64)
    for u, (first, _) in enumerate(probe.schedule):
        want[(u // probe.per_step) % blocks] += src[first:first + chunk_rows].astype(np.int64).sum()
    want = ((want * passes) & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    got = probe(torch.as_tensor(src), passes=passes, blocks=blocks)
    assert np.array_equal(got.numpy(), want) and p23.launches[probe.name] == 0
    # The blocks split the units; their wrapping total does not depend on it.
    total = probe(torch.as_tensor(src), passes=passes).numpy()
    wrapped = np.uint32(got.numpy().astype(np.int64).sum() & 0xFFFFFFFF)
    assert total.shape == (1,) and wrapped == total.view(np.uint32)[0]


READ_VARIANTS = list(dict.fromkeys(v for p in p23.PROBES.values() for v in p))
H100_SMS = 132
SM_SHARED = 233472  # an SM's shared memory for all its blocks
BLOCK_RESERVED = 1024  # what the card keeps of it per resident block


@pytest.mark.parametrize("variant,kb", READ_VARIANTS)
def test_card_ring_fits_shared_memory_and_keeps_bytes_in_flight(variant, kb):
    probe = p23.BulkRead(variant, kb * 1024 // p23.ROW_BYTES)
    chunk = probe.chunk_rows * p23.ROW_BYTES
    # At least nested's 4 KB figure in flight per SM: 2 x 7 slots of 4 KB.
    assert probe.bytes_in_flight_per_sm() >= 56 * 1024
    if variant == "nested":
        assert probe.slots() == 2 * p23.STREAMS and 2 * p23.STREAMS * chunk <= p23.BLOCK_SHARED
        return
    for per_sm in (1, 2):
        assert probe.slots(per_sm) == p23.ring_slots(probe.chunk_rows, per_sm)
        assert probe.bytes_in_flight_per_sm(per_sm) == per_sm * probe.slots(per_sm) * chunk
        assert probe.bytes_in_flight_per_sm(per_sm) == probe.bytes_in_flight_per_sm()  # per SM
        shared = p23.RING_STATIC_SHARED + p23.ring_shared_bytes(
            variant, probe.chunk_rows, probe.units, per_sm * H100_SMS, H100_SMS)
        assert shared <= p23.BLOCK_SHARED
        assert per_sm * (shared + BLOCK_RESERVED) <= SM_SHARED  # both blocks resident
    # Bytes, not the TPU's 4 slots: 16 of 4 KB, 4 of 16 KB and 4 of 48 KB.
    assert probe.slots() == {4: 16, 16: 4, 48: 4}[kb]


def test_ring_slots_follow_the_byte_budget():
    assert [p23.ring_slots(rows) for rows in (8, 32, 96)] == [16, 4, 4]
    assert [p23.ring_slots(rows, 2) for rows in (8, 32, 96)] == [8, 2, 2]
    assert p23.ring_slots(1) == p23.MAX_SLOTS  # 128 slots of 512 B would not fit the barriers
    assert p23.ring_slots(384) == p23.MIN_SLOTS == 4  # 192 KB chunks: 4 slots an SM (refused: too big)
    assert p23.ring_slots(384, 8) == 1  # a block keeps one slot at least
    assert p23.RING == 4  # the TPU's ring, read_schedule's slot column, is kept apart


@pytest.mark.parametrize("blocks", [1, 3, 132])
@pytest.mark.parametrize("chunk_rows", [16, 24])
def test_table_share_lists_the_rows_a_block_reads(blocks, chunk_rows):
    rng = np.random.default_rng(12)
    src = rng.integers(-2**31, 2**31, (READ_ROWS, 128)).astype(np.int32)
    probe = p23.BulkRead("table", chunk_rows, rows=READ_ROWS)
    sums = probe.plain(torch.as_tensor(src), blocks).numpy()
    for i in range(blocks):
        mine = [u for u in range(probe.units) if u % blocks == i]
        share = probe.schedule[i::blocks, 0]  # table[i], table[i + grid], ...: what block i stages
        assert np.array_equal(share, probe.schedule[mine, 0])
        total = sum(int(src[r:r + chunk_rows].astype(np.int64).sum()) for r in share)
        assert np.uint32(total & 0xFFFFFFFF) == sums[i:i + 1].view(np.uint32)[0]
    # The largest share is block 0's; its 4-byte entries sit after the slots.
    shared = p23.ring_shared_bytes("table", chunk_rows, probe.units, blocks, blocks)
    ring = p23.ring_slots(chunk_rows) * chunk_rows * p23.ROW_BYTES
    assert shared - ring >= 4 * len(probe.schedule[::blocks]) > shared - ring - 16


@pytest.mark.parametrize("variant", ["strided", "table", "nested"])
@pytest.mark.parametrize("chunk_rows", [16, 24])
def test_read_library_sums_the_words_the_variant_reads(variant, chunk_rows):
    rng = np.random.default_rng(13)
    src = torch.as_tensor(rng.integers(-2**31, 2**31, (READ_ROWS, 128)).astype(np.int32))
    probe = p23.BulkRead(variant, chunk_rows, rows=READ_ROWS)
    call, moved = probes.read_library(probe, src)
    assert moved == probe.bytes_per_pass
    total = call()
    assert total.dtype == torch.int64 and total.numel() == 1
    want = probe.plain(src, 5).long().sum()
    assert p23.wrap_int32(total) == p23.wrap_int32(want)


def test_read_variants_and_sizes():
    assert p23.PROBES["p2"] == [(v, kb) for v in ("seq", "strided") for kb in (4, 16, 48)]
    full = p23.BulkRead("seq", 32)
    assert full.bytes_per_pass == 256 * 2**20 and full.name == "seq_16KB"
    nested = p23.BulkRead("nested", 32)
    # 7 planes of 65536 rows in chunks of 32 rows; 2 x 7 slots of 16 KB fit 227 KB.
    assert nested.units == 7 * 2048 and 2 * 7 * 32 * 512 <= 232448
    assert p23.BulkRead("strided", 96).units == 7 * (65536 // 96)


# -- P4 ---------------------------------------------------------------------------

P4_GEOMETRY = dict(HBM_ROWS=1 << 12, WAVE=16)


@pytest.mark.parametrize("vmem_rows", [256, 64])
def test_stage_tables_match_dma_probe(monkeypatch, vmem_rows):
    copy_rows = 4
    script = load_script("dma_probe", monkeypatch, VMEM_ROWS=vmem_rows, jnp=DistinctZeros(), **P4_GEOMETRY)
    got = np.asarray(script.build(copy_rows, 1, "stage")())
    v = p4.BulkCopies("stage", copy_rows, wave=16, target_rows=1 << 12, region_rows=vmem_rows)
    last = max(k for k in range(16) if v.smem[k] == 0)
    first = int(v.dst[0, last])
    assert np.array_equal(got[:copy_rows], source_rows(1 << 12)[first:first + copy_rows])


@pytest.mark.parametrize("entries", [16, 8, 2])
def test_waits_per_wave_match_build_tiny_loops(monkeypatch, entries):
    script = load_script("dma_probe", monkeypatch, VMEM_ROWS=256, **P4_GEOMETRY)
    _, n_loops = script.build_tiny_loops(4, 1, entries)
    v = p4.BulkCopies("scatter", 4, entries=entries, wave=16, target_rows=1 << 12, region_rows=256)
    # The TPU probe's one issuer: one block, one warp, the whole wave.
    one = p4.issue_groups("scatter", v.copy_smem, 4, v.group, blocks=1, warps=1)
    assert len(one[0, 0]) == n_loops
    # The kernel's eight issuing warps wait for 2 copies each.
    assert v.waits_per_wave == -(-2 // entries)


def test_copy_tables_and_groups():
    dst, smem = p4.copy_tables(1)
    rng = np.random.default_rng(0)
    assert np.array_equal(dst[0], rng.permutation((1 << 20) // 8)[:512] * 8)
    assert np.array_equal(smem, (np.arange(512) % 48) * 8)
    # Many blocks: a region of wave x G rows each, every slot once.
    dst, _ = p4.copy_tables(32, blocks=132)
    for b in range(132):
        assert sorted(dst[b] - b * 512 * 32) == list(range(0, 512 * 32, 32))
    assert p4.BulkCopies("scatter", 32, blocks=132).target_rows * 512 <= 1.2e9
    assert [p4.group_size("stage", r, 512) for r in (1, 32, 256)] == [48, 12, 1]
    assert [p4.group_size("stage", 32, e) for e in (8, 2)] == [8, 2]
    assert p4.group_size("scatter", 256, 512) == 512
    names = [v.name for v in probes.copy_variants(132)]
    assert len(names) == len(set(names)) == 20 and "stage_16KB_x1_e8" in names
    assert {f"{d}_{s}_card" for d in p4.DIRECTIONS for s in ("512B", "16KB", "128KB")} <= set(names)


@pytest.mark.parametrize("blocks,copy_rows", [(1, 1), (1, 4), (3, 4), (3, 16)])
def test_scatter_and_stage_plain_match_numpy_loops(blocks, copy_rows):
    geometry = dict(wave=16, target_rows=1 << 12, region_rows=64)
    rng = np.random.default_rng(3)
    image = rng.integers(-2**31, 2**31, (64, 128)).astype(np.int32)
    scatter = p4.BulkCopies("scatter", copy_rows, blocks, **geometry)
    want = np.zeros((scatter.target_rows, 128), np.int32)
    for b in range(blocks):
        for k in range(16):
            to, frm = scatter.dst[b, k], scatter.smem[k]
            want[to:to + copy_rows] = image[frm:frm + copy_rows]
    target = torch.zeros((scatter.target_rows, 128), dtype=torch.int32)
    got = scatter.scatter(torch.as_tensor(image), target, waves=2)
    assert got is target and np.array_equal(got.numpy(), want)

    stage = p4.BulkCopies("stage", copy_rows, blocks, **geometry)
    source = rng.integers(-2**31, 2**31, (stage.target_rows, 128)).astype(np.int32)
    sums = []
    for b in range(blocks):
        region = np.zeros((64, 128), np.int64)
        for k in range(16):
            to, frm = stage.smem[k], stage.dst[b, k]
            region[to:to + copy_rows] = source[frm:frm + copy_rows]
        sums.append(region.sum() & 0xFFFFFFFF)
    want = np.array(sums, np.int64).astype(np.uint32).view(np.int32)
    assert np.array_equal(stage.stage(torch.as_tensor(source), waves=2).numpy(), want)
    assert np.array_equal(stage.stage(torch.as_tensor(source), waves=0).numpy(), np.zeros(blocks, np.int32))
    assert sum(p4.launches.values()) == 0


def stage_plain_one_block(source, dst, smem, copy_rows, waves=1):
    """The stage's plain version before the wave was dealt over the card
    (one block's sums, each slot holding the last copy into it), kept to
    hold the dealt one equal to it on one block."""
    blocks, wave = dst.shape
    if waves == 0:
        return torch.zeros(blocks, dtype=torch.int32, device=source.device)
    last = {int(s): k for k, s in enumerate(smem)}
    rows = dst[:, sorted(last.values())][:, :, None] + np.arange(copy_rows)
    picked = source.index_select(0, torch.as_tensor(rows.reshape(-1), device=source.device))
    return p4.wrap_int32(picked.view(blocks, -1).sum(1, dtype=torch.int64))


@pytest.mark.parametrize("direction", p4.DIRECTIONS)
@pytest.mark.parametrize("copy_rows,blocks,regions", [  # the card-wide, x1 and x132 variants
    (r, b, g) for r in (1, 32, 256) for b, g in ((132, 1), (1, 1), (132, 132)) if g == 1 or r < 256])
def test_card_wide_deal_issues_every_copy_once(direction, copy_rows, blocks, regions):
    v = p4.BulkCopies(direction, copy_rows, blocks=blocks, regions=regions)
    issued = [k for groups in v.groups.values() for g in groups for k in g]
    assert sorted(issued) == list(range(v.copies)) and v.copies == regions * p4.WAVE
    g = p4.spacing(copy_rows)
    for (b, w), groups in v.groups.items():
        assert 0 <= w < p4.WARPS and all(k % blocks == b for grp in groups for k in grp)
        assert all(0 < len(grp) <= v.group for grp in groups)
        if direction == "stage":  # a warp owns its slots; no slot twice in flight
            slots = [[v.copy_smem[k] // g for k in grp] for grp in groups]
            assert all(s % p4.WARPS == w for grp in slots for s in grp)
            assert all(len(set(grp)) == len(grp) for grp in slots)
    # A block's copies land in the slots of their share positions; a scatter
    # block loads the image slots of its share's length, no more.
    for b in range(min(blocks, v.copies)):
        share = np.arange(b, v.copies, blocks)
        assert np.array_equal(v.copy_smem[share], v.smem[:len(share)])
        mask = p4.share_slots(v.smem, copy_rows, len(share))
        assert mask == sum(1 << int(s) for s in set(v.copy_smem[share] // g))
    if regions == 1:  # the card-wide wave is the one-block wave's copies
        assert np.array_equal(v.copy_dst, p4.copy_tables(copy_rows)[0][0])


@pytest.mark.parametrize("blocks,copy_rows", [(1, 1), (3, 1), (3, 4), (5, 16)])
def test_dealt_scatter_and_stage_plain_match_numpy_loops(blocks, copy_rows):
    geometry = dict(wave=16, target_rows=1 << 12, region_rows=64, regions=1)
    rng = np.random.default_rng(5)
    image = rng.integers(-2**31, 2**31, (64, 128)).astype(np.int32)
    scatter = p4.BulkCopies("scatter", copy_rows, blocks, **geometry)
    to, frm = (torch.as_tensor(a) for a in p4.scatter_rows(scatter.copy_dst, scatter.copy_smem, copy_rows))
    want = torch.zeros((scatter.target_rows, 128), dtype=torch.int32)
    want.index_copy_(0, to, torch.as_tensor(image).index_select(0, frm))  # the library call
    got = scatter.scatter(torch.as_tensor(image), torch.zeros_like(want), waves=2)
    assert torch.equal(got, want)

    stage = p4.BulkCopies("stage", copy_rows, blocks, **geometry)
    source = rng.integers(-2**31, 2**31, (stage.target_rows, 128)).astype(np.int32)
    sums = []
    for b in range(blocks):  # block b's share: copies b, b + blocks, ... into slots of their positions
        region = np.zeros((64, 128), np.int64)
        for i, k in enumerate(range(b, 16, blocks)):
            to_, frm_ = stage.smem[i], stage.dst[0, k]
            region[to_:to_ + copy_rows] = source[frm_:frm_ + copy_rows]
        sums.append(region.sum() & 0xFFFFFFFF)
    want = np.array(sums, np.int64).astype(np.uint32).view(np.int32)
    assert np.array_equal(stage.stage(torch.as_tensor(source), waves=2).numpy(), want)
    if blocks == 1:
        old = stage_plain_one_block(torch.as_tensor(source), stage.dst, stage.smem, copy_rows)
        assert np.array_equal(old.numpy(), want)
    assert sum(p4.launches.values()) == 0


# -- refusals ---------------------------------------------------------------------

def test_wrappers_refuse_what_the_kernels_do_not_take():
    packed, b0 = (torch.as_tensor(a) for a in p1.probe_inputs(16, 1024))
    with pytest.raises(ValueError, match="unknown variant"):
        p1.columns_chain("wgmma", packed, b0, 1)
    with pytest.raises(ValueError, match=r"\[W, T1\]"):
        p1.columns_chain("cuda_cores", packed[:1], b0, 1)
    meta = torch.zeros(1000, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="multiple of 1024"):
        p1.columns_chain("cuda_cores", packed.to("meta"), meta, 1)
    with pytest.raises(ValueError, match="unknown variant"):
        p23.read_schedule("random", 1024, 16)
    with pytest.raises(ValueError, match="int32"):
        p23.BulkRead("seq", 16, rows=1024)(torch.zeros((1024, 128)))
    with pytest.raises(ValueError, match="unknown direction"):
        p4.BulkCopies("gather", 1)
    with pytest.raises(ValueError, match="this variant stages"):
        p4.BulkCopies("stage", 1).scatter(None, None)


def test_a_cuda_request_without_a_card_raises(monkeypatch):
    """A tensor off the CPU goes to the kernel, which needs a CUDA device."""
    packed, b0 = (torch.as_tensor(a).to("meta") for a in p1.probe_inputs(16, 1024))
    with pytest.raises(ValueError, match="cuda device"):
        p1.columns_chain("cuda_cores", packed, b0, 1)
    meta = torch.zeros((1024, 128), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda device"):
        p23.BulkRead("seq", 16, rows=1024)(meta, blocks=2)
    v = p4.BulkCopies("stage", 4, wave=16, target_rows=1 << 12, region_rows=64)
    with pytest.raises(ValueError, match="cuda device"):
        v.stage(torch.zeros((1 << 12, 128), dtype=torch.int32, device="meta"))
    assert sum(p1.launches.values()) + sum(p23.launches.values()) + sum(p4.launches.values()) == 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for measure in (probes.measure_columns, probes.measure_copies):
        with pytest.raises(RuntimeError, match="CUDA"):
            measure()
    with pytest.raises(RuntimeError, match="CUDA"):
        probes.measure_reads(["p2"])


def test_the_probe_entry_point_refuses_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for only in ([], ["--only", "p1"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli_probes.main([*only, "--out", str(tmp_path / "p.json")])
    assert not (tmp_path / "p.json").exists()
