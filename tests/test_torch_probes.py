"""The probes P1-P4 of the PyTorch port against the JAX probe scripts.

The scripts (``scripts/mxu_col_probe.py``, ``read_bw_probe.py``,
``read_bw_probe2.py``, ``dma_probe.py``) are loaded unedited with
``importlib``; their Pallas kernels run in interpret mode (the module's
``pl`` is swapped for a namespace whose ``pallas_call`` interprets) at sizes
shrunk through their module globals:

- P1: the plain column-build chain equals ``vpu_variant`` and
  ``mxu_variant`` bit for bit on the scripts' own inputs, at both packings;
  the roofline's formula count of ``extract``'s and the update's
  operations is what tracing them counts, and the bound takes the smaller
  of it and the kernel's count in each class, naming the class that binds; a plain model of the tensor-core kernel (the PTX fragment
  layouts of its u8 mma, ``__byte_perm`` and the shuffles) over the B
  fragments the wrapper builds gives every lane all W words of its own
  element for every b, and the CUDA-core table the wrapper lays out gives
  ``packed[:, b]`` at conflict-free addresses;
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
    assert roofline.DATA_SHEET_OPS_PER_S["tensor_int8"] == 1979e12
    assert roofline.DATA_SHEET_OPS_PER_S["shared_words"] == roofline.DATA_SHEET_OPS_PER_S["lookup"]
    # The mma on the column's 4W bytes, not the kernel's padded n-tiles.
    assert p1.mma_flops_per_step(16) == 2 * 16 * 8 and p1.mma_flops_per_step(32) == 2 * 32 * 20
    # CUDA cores: W words of shared memory, in the loads the layout needs
    # (one 128-bit and one 32-bit at T1 = 32), which alone count as issue.
    ops = probes.column_ops("cuda_cores", 32, 10)
    assert ops == {"shared_words": 50, "lookup": 20, "logic": 65, "compare": 20, "int32": 30}
    assert probes.column_ops("tensor_cores", 16, 1) == {"tensor_int8": 256, **roofline.COLUMN_STEP_OPS[16]}
    b = roofline.bound(0, ops)
    issue_ms = (20 + 65 + 20 + 30) / roofline.DATA_SHEET_OPS_PER_S["issue"] * 1e3
    assert b["busiest"] == "shared_words" and b["compute_ms"] > issue_ms
    assert roofline.bound(0, {"shared_words": 1.0, "tensor_int8": 1.0})["busiest"] == "shared_words"


@pytest.mark.parametrize("variant,t1,per_clock,busiest", [
    # Per SM and clock: T1 = 16 issues 2 loads and 10 integer operations a
    # step at 128 a clock; T1 = 32 moves 5 words at 32 a clock; the tensor
    # cores' 16 issue 10 (tied with the logic pipe's 5 at 64); their 32's
    # mma, 1280 int8 operations at 1979 TOP/s, binds.
    ("cuda_cores", 16, 128 / 12, ("issue",)),
    ("cuda_cores", 32, 32 / 5, ("shared_words",)),
    ("tensor_cores", 16, 128 / 10, ("issue", "logic")),
    ("tensor_cores", 32, 1979e12 / 1280 / (roofline.SMS * roofline.BOOST_HZ), ("tensor_int8",)),
])
def test_column_bound_names_the_class_that_binds(variant, t1, per_clock, busiest):
    b = probes.column_bound(variant, t1)
    assert b["per_s"] == pytest.approx(per_clock * roofline.SMS * roofline.BOOST_HZ, rel=1e-12)
    assert b["busiest"] in busiest


def test_integer_sass_counts_follow_their_classes():
    opcodes = {"LOP3": 4, "SHF": 1, "PRMT": 2, "SEL": 2, "ISETP": 1, "IMAD": 3, "LEA": 1,
               "SHFL": 1, "IMMA": 2, "LDS": 2, "BRA": 1}
    assert roofline.sass_counts(opcodes, roofline.INTEGER_PIPE_OPCODES) == {
        "logic": 7, "compare": 3, "int32": 4, "shuffle": 1, "mma": 2, "lookup": 2, "issue": 20}
    # The float table is unchanged: integer work counts as issue only.
    assert roofline.sass_counts(opcodes) == {"lookup": 2, "issue": 20}


class Op:
    """A value in a traced column step: every operation on it is recorded
    once per distinct (operation, operands), as a compiler keeps it."""

    CLASS = {"rshift": "logic", "lshift": "logic", "and": "logic", "or": "logic",
             "add": "int32", "mul": "int32", "eq": "compare", "where": "compare"}

    def __init__(self, seen, key):
        self.seen, self.key = seen, key

    def _op(self, name, other, swap=False):
        o = other.key if isinstance(other, Op) else ("const", other)
        key = (name, o, self.key) if swap else (name, self.key, o)
        self.seen.setdefault(key, None)
        return Op(self.seen, key)

    def __rshift__(self, o): return self._op("rshift", o)
    def __lshift__(self, o): return self._op("lshift", o)
    def __and__(self, o): return self._op("and", o)
    def __or__(self, o): return self._op("or", o)
    def __add__(self, o): return self._op("add", o)
    def __radd__(self, o): return self._op("add", o, True)
    def __mul__(self, o): return self._op("mul", o)
    def __rmul__(self, o): return self._op("mul", o, True)
    def __eq__(self, o): return self._op("eq", o)
    __hash__ = None

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        assert func is torch.where
        c, x, y = args
        key = ("where", c.key, x.key, y.key)
        c.seen.setdefault(key, None)
        return Op(c.seen, key)


@pytest.mark.parametrize("t1", [16, 32])
def test_column_step_ops_count_the_extract_and_the_update(t1):
    fb, w = p1.CONFIGS[t1]
    seen = {}
    cols = [Op(seen, ("word", k)) for k in range(w)]
    b, acc = Op(seen, "b"), Op(seen, "acc")
    e = p1.extract(cols, b, fb)
    acc = acc + cols[0]
    b = (e + b) & (t1 - 1)
    counts = {}
    for key in seen:
        counts[Op.CLASS[key[0]]] = counts.get(Op.CLASS[key[0]], 0) + 1
    assert counts == roofline.COLUMN_FORMULA_OPS[t1]
    # The bound takes the smaller of the formula's and the kernel's count.
    sass = roofline.COLUMN_SASS_OPS[t1]
    assert roofline.COLUMN_STEP_OPS[t1] == {k: min(n, sass[k]) for k, n in counts.items()}


# A plain model of csrc/lut_columns.cu's tensor_cores_kernel on one tile pair
# of one warp, with the PTX ISA's fragment layouts of
# mma.m16n8k16 / m16n8k32 .row.col.s32.u8.u8.s32 (lane = 4 g + q):
#   A, register r: 4 bytes of row g + 8 (r & 1), k = 16 (r >> 1) + 4 q + i;
#   B, register r: 4 bytes of column g, k = 16 r + 4 q + i;
#   C, register j: row g + 8 (j >> 1), column 2 q + (j & 1).
LANE = np.arange(32)
G, Q = LANE >> 2, LANE & 3
Q0, Q1 = Q & 1, Q >> 1


def byte_perm(x, y, s):
    """``__byte_perm`` per lane: byte i of the result is byte ``s >> 4 i &
    7`` of the 8 bytes of (y, x), x low."""
    x, y, s = (np.broadcast_to(np.asarray(v, dtype=np.uint64), LANE.shape) for v in (x, y, s))
    pool = x | (y << np.uint64(32))
    out = np.zeros(LANE.shape, dtype=np.uint64)
    for i in range(4):
        sel = (s >> np.uint64(4 * i)) & np.uint64(7)
        out |= ((pool >> (np.uint64(8) * sel)) & np.uint64(255)) << np.uint64(8 * i)
    return out


def shfl(v, src):
    return np.asarray(v)[src]


def shl1(s):
    """PTX ``shl.b32 1, s``: the amount is unsigned and clamped at 32."""
    s = np.asarray(s, dtype=np.int64) & 0xFFFFFFFF
    return np.where(s < 32, np.left_shift(1, np.minimum(s, 31)), 0).astype(np.uint64)


def mma(a, bf, t1):
    """The accumulators [32, 4] of one m16n8k(T1) u8 mma from each lane's A
    and B registers, and the A and B matrices they form."""
    amat, bmat = np.full((16, t1), -1, np.int64), np.full((t1, 8), -1, np.int64)
    for lane in LANE:
        g, q = lane >> 2, lane & 3
        for r, reg in enumerate(a):
            for i in range(4):
                amat[g + 8 * (r & 1), 16 * (r >> 1) + 4 * q + i] = int(reg[lane]) >> 8 * i & 255
        for r, reg in enumerate(bf):
            for i in range(4):
                bmat[16 * r + 4 * q + i, g] = int(reg[lane]) >> 8 * i & 255
    assert (amat >= 0).all() and (bmat >= 0).all()  # every entry from one lane
    d = amat @ bmat
    c = np.stack([d[G + 8 * (j >> 1), 2 * Q + (j & 1)] for j in range(4)], axis=1)
    return c.astype(np.uint64), amat, bmat


def tensor_pair_step(frags, b, t1):
    """One step of a tile pair as the kernel runs it: each lane's A
    registers per tile, its accumulators per tile and n-tile, and its words
    in the lane's order (``cols``)."""
    kr, nt_count, w = t1 // 16, p1.N_TILES[t1], p1.CONFIGS[t1][1]
    bf = [[frags[nt, r] for r in range(kr)] for nt in range(nt_count)]
    tile = np.where(Q1, 0x0004, 0x0040)
    row = np.where(Q0, 0x0004, 0x0040)
    keep = np.where(Q1, np.where(Q0, 0x3276, 0x1054), np.where(Q0, 0x7632, 0x5410))
    send = np.where(Q1, np.where(Q0, 0x1054, 0x3276), np.where(Q0, 0x5410, 0x7632))
    word4 = np.where(Q0, 0x1076, 0x7610)
    group = LANE & ~3
    a = [[None] * (t1 // 8) for _ in range(2)]
    for t in range(2):
        for h in range(2):
            s = 8 * shfl(b, group + 2 * t + h).astype(np.int64) - 32 * Q
            for r in range(kr):
                a[t][2 * r + h] = shl1(s - 128 * r)
    c, mats = [[None] * nt_count for _ in range(2)], []
    for t in range(2):
        for nt in range(nt_count):
            c[t][nt], amat, bmat = mma(a[t], bf[nt], t1)
            mats.append((t, nt, amat, bmat))
    cols = [None] * w
    nx = 2 * (w // 2)
    for x in range(nx // 2):
        u = []
        for h in range(2):
            m0 = byte_perm(c[0][x][:, 2 * h], c[1][x][:, 2 * h], tile)
            m1 = byte_perm(c[0][x][:, 2 * h + 1], c[1][x][:, 2 * h + 1], tile)
            u.append(byte_perm(m0, m1, 0x5140))
        kept = byte_perm(u[0], u[1], 0x5410)
        got = shfl(byte_perm(u[0], u[1], 0x7632), LANE ^ 2)
        cols[2 * x] = byte_perm(kept, got, keep)
        cols[2 * x + 1] = shfl(byte_perm(kept, got, send), LANE ^ 1)
    if w > nx:
        v = []
        for j in range(2):
            y = byte_perm(c[0][-1][:, j], c[1][-1][:, j], tile)
            z = byte_perm(c[0][-1][:, 2 + j], c[1][-1][:, 2 + j], tile)
            v.append(byte_perm(y, z, row))
        u = byte_perm(v[0], v[1], 0x5140)
        cols[w - 1] = byte_perm(u, shfl(u, LANE ^ 1), word4)
    return mats, c, cols


@pytest.mark.parametrize("t1", [16, 32])
def test_tensor_core_fragments_reproduce_the_columns(t1):
    fb, w = p1.CONFIGS[t1]
    packed, _ = p1.probe_inputs(t1, 32, seed=7)
    words = packed.astype(np.int64) & 0xFFFFFFFF
    frags = p1.b_fragments(torch.as_tensor(packed)).numpy().astype(np.int64) & 0xFFFFFFFF
    mat = p1.byte_matrix(torch.as_tensor(packed)).numpy()
    assert frags.shape == (p1.N_TILES[t1], t1 // 16, 32)
    # The element of each lane: row g + 8 q0 of tile q1, element 16 t + row.
    element = 16 * Q1 + G + 8 * Q0
    for shift in range(t1):  # every element meets every b, a group's four differ
        b_of = (np.arange(32) * 5 + shift) % t1  # b per element of the pair
        b = b_of[element]
        mats, c, cols = tensor_pair_step(frags, b, t1)
        for t, nt, amat, bmat in mats:
            rows = b_of[16 * t:16 * t + 16]
            assert np.array_equal(amat, np.eye(t1, dtype=np.int64)[rows])  # one-hot A
            assert np.array_equal(bmat, mat[:, 8 * nt:8 * nt + 8])
            # Accumulators: column 2q + (j & 1) of the byte matrix at row b.
            for j in range(4):
                want = mat[rows[G + 8 * (j >> 1)], 8 * nt + 2 * Q + (j & 1)]
                assert np.array_equal(c[t][nt][:, j], want)
        # Every lane holds all W words of its own element, in the lane's
        # order: word k (< 4) at k ^ q0, the high-bit word last.
        for k in range(w):
            at = k ^ Q0 if k < 2 * (w // 2) else np.full(32, k)
            got = np.stack(cols)[at, LANE]
            assert np.array_equal(got, words[k, b])
        # The extract on them, word index flipped by q0, is the plain one.
        lane_cols = [torch.as_tensor(np.stack(cols)[k].astype(np.int64)) for k in range(w)]
        a = torch.as_tensor(b.astype(np.int64))
        flipped = extract_flipped(lane_cols, a, torch.as_tensor(Q0), fb)
        want = p1.extract([torch.as_tensor(words[k, b]) for k in range(w)], a, fb)
        assert torch.equal(flipped, want)


def extract_flipped(cols, a, q0, fb):
    """The kernel's extract on a lane's words: the word that ``a ^ (q0 <<
    3)`` selects, the field of ``a`` in it."""
    wa = a ^ (q0 << 3)
    word = cols[0]
    last = len(cols) - (fb == 5)
    for k in range(1, last):
        word = torch.where((wa >> 3) == k, cols[k], word)
    field = (word >> (fb if fb != 5 else 4) * (a & 7)) & (15 if fb == 5 else (1 << fb) - 1)
    if fb == 5:
        field = field | (((cols[-1] >> (a & 31)) & 1) << 4)
    return field


@pytest.mark.parametrize("t1", [16, 32])
def test_cuda_core_table_reads_the_columns(t1):
    """The words csrc/lut_columns.cu's cuda_cores_kernel reads for column b
    from the table :func:`cuda_table` lays out are ``packed[:, b]``; at T1 =
    32 the 128-bit load of the 8 lanes of a quarter-warp phase falls in 8
    different bank groups of 16 bytes whatever their b."""
    w = p1.CONFIGS[t1][1]
    packed, _ = p1.probe_inputs(t1, 32, seed=9)
    table = p1.cuda_table(torch.as_tensor(packed)).numpy()
    want_words = 8 * t1 * 4 + t1 if t1 == 32 else w * t1
    assert table.shape == (want_words,)
    rng = np.random.default_rng(0)
    for b in list(range(t1)) + [rng.integers(0, t1, 32) for _ in range(8)]:
        b = np.broadcast_to(b, LANE.shape)
        if t1 == 32:
            at = (b * 8 + (LANE & 7)) * 4  # uint4 index b * 8 + lane % 8
            got = [table[at + k] for k in range(4)] + [table[8 * t1 * 4 + b]]
            for phase in range(4):
                lanes = slice(8 * phase, 8 * phase + 8)
                assert len(set((at[lanes] // 4) % 8)) == 8
        else:
            got = [table[k * t1 + b] for k in range(w)]
        assert np.array_equal(np.stack(got), packed[:, b])


def test_column_operands_are_built_once_per_unchanged_lut():
    packed = torch.as_tensor(p1.probe_inputs(32, 32, seed=3)[0])
    cpu = torch.device("cpu")
    for variant in p1.VARIANTS:
        first = p1._operand_on(variant, packed, cpu)
        assert p1._operand_on(variant, packed, cpu) is first
        assert torch.equal(first, p1.operand(variant, packed))
        packed.add_(1)  # changed in place: built again
        again = p1._operand_on(variant, packed, cpu)
        assert again is not first and torch.equal(again, p1.operand(variant, packed))
        assert p1._operand_on(variant, packed.clone(), cpu) is not again


def test_column_library_builds_one_steps_columns():
    packed, b0 = (torch.as_tensor(a) for a in p1.probe_inputs(32, 1024, seed=4))
    b = b0.long() & 31
    cols = probes.column_library(packed, b)()
    assert torch.equal(cols, torch.stack([packed[k][b] for k in range(5)]))


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
