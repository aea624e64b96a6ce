"""The probes P5 and P6 of the PyTorch port against the JAX probe scripts.

``scripts/stage_probe.py`` and ``scripts/stage_replay.py`` are loaded
unedited with ``importlib``, as ``tests/test_torch_probes.py`` loads the
other probes:

- P5: at a shrunk geometry (module globals), the script's Pallas kernel runs
  in interpret mode on a distinct-valued source, and the rows its slot 0
  holds last are the rows ``stage_schedule`` puts last into slot 0;
- P6: ``build`` runs with a ``pallas_call`` that only records the kernel, on
  the DVB-S2 layout; the kernel's closure holds the script's stage program
  (groups, chunk strides and counts from ``KH._group_chunk_counts`` and
  ``KH.chunk_geom``, the channel staging), and the rows it stages are the
  rows the port's replay reads, once each;
- the plain checksums and views against numpy loops on small layouts; P6's
  kernel as a plain model of K3's wide passes (``csrc/hbm_wide.cuh``: each
  thread's node rows and 8- or 4-column chunk, the degree split, the fold
  on 32-bit words of four columns) covering every (node, column) once and
  equal to the plain replay; the wrappers' and the entry point's refusals.
"""

import types

import numpy as np
import pytest
import torch
from test_torch_probes import DistinctZeros, load_script, source_rows

from informationbottleneckdecodingldpc_tpu.models import get_model as jax_model
from informationbottleneckdecodingldpc_torch.cli import probes as cli_probes
from informationbottleneckdecodingldpc_torch.codes import (
    TannerGraph,
    dvbs2_layout_edge_keys,
    dvbs2_layout_node_keys,
    dvbs2_like_parity_check,
)
from informationbottleneckdecodingldpc_torch.decode import DecodeLayout
from informationbottleneckdecodingldpc_torch.kernels import stage_chunks as p5
from informationbottleneckdecodingldpc_torch.kernels import stage_replay as p6
from informationbottleneckdecodingldpc_torch.models import get_model
from informationbottleneckdecodingldpc_torch.utils import probes

# -- P5 ---------------------------------------------------------------------------

STRIDE, N_CHUNKS = 8, 4
SMALL = dict(stride=STRIDE, n_chunks=N_CHUNKS, plane=N_CHUNKS * STRIDE)
# Room for 'unalign''s j 1237 + 3 extra rows, as the script leaves it.
SMALL_ROWS = p5.D * N_CHUNKS * STRIDE + STRIDE + 16384


@pytest.mark.parametrize("variant", p5.VARIANTS)
def test_stage_schedule_matches_stage_probe(monkeypatch, variant):
    script = load_script("stage_probe", monkeypatch, STRIDE=STRIDE, N_CHUNKS=N_CHUNKS,
                         PLANE=SMALL["plane"], HBM_ROWS=SMALL_ROWS, jnp=DistinctZeros())
    got = np.asarray(script.build(variant, 2)())
    schedule = p5.stage_schedule(variant, **SMALL)
    first = int(schedule[schedule[:, 3] == 0][-1, 2])
    assert np.array_equal(got, source_rows(SMALL_ROWS)[first:first + 8])


def test_stage_geometry_is_the_scripts():
    assert (p5.D, p5.STRIDE, p5.N_CHUNKS, p5.HBM_ROWS) == (7, 2048, 40, 591_872)
    for variant in p5.VARIANTS:
        probe = p5.StageChunks(variant)
        assert probe.bytes_per_iteration == 7 * 40 * 2048 * 512  # 293.6 MB
        assert probe.units == 40 * 2048 // probe.piece_rows
        # The writing variants hold S_in and S_out (pipeline: two halves of
        # each) in one block's 227 KB, beside 144 bytes of static shared memory.
        halves = 2 if variant == "pipeline" else 1
        copies = (2 if variant in p5.WRITES else 1) * halves
        assert copies * 7 * probe.piece_rows * 512 + 144 <= 232_448
    schedule = p5.stage_schedule("unalign")
    assert schedule[:7, 2].tolist() == [j * 81920 + j * 1237 + 3 for j in range(7)]
    assert set(p5.TPU_ONLY) | set(p5.VARIANTS) == {
        "base", "dynsem", "when", "vwrite", "dynread", "dynoff", "unalign", "pipeline"}


@pytest.mark.parametrize("variant", p5.VARIANTS)
def test_stage_checksums_plain_match_a_numpy_loop(variant):
    rng = np.random.default_rng(5)
    src = rng.integers(-2**31, 2**31, (SMALL_ROWS, 128)).astype(np.int32)
    probe = p5.StageChunks(variant, rows=SMALL_ROWS, piece_rows=4, **SMALL)
    blocks, iters = 3, 2
    want = np.zeros(blocks, np.int64)
    for u in range(probe.units):
        for j in range(p5.D):
            first = int(probe.bases[j]) + u * 4
            staged = src[first:first + 4].astype(np.int64)
            want[u % blocks] += staged.sum() + ((staged + 1).sum() if variant in p5.WRITES else 0)
    want = ((want * iters) & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    got = probe(torch.as_tensor(src), iters=iters, blocks=blocks)
    assert np.array_equal(got.numpy(), want) and p5.launches[variant] == 0
    total = probe(torch.as_tensor(src), iters=iters).numpy()  # one block on the CPU
    assert total.view(np.uint32)[0] == np.uint32(got.numpy().astype(np.int64).sum() & 0xFFFFFFFF)


# -- P6 ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dvbs2():
    return get_model("dvbs2-64800").make_layout(), jax_model("dvbs2-64800").make_layout()


def script_program(monkeypatch, jlayout, variant):
    """The stage program ``stage_replay.py`` ``build`` gives ``variant``:
    the closure of the kernel it hands to ``pallas_call``, which is recorded
    and never run."""
    recorded = {}

    def pallas_call(kernel, **_):
        recorded["kernel"] = kernel
        return lambda *args: None

    script = load_script("stage_replay", monkeypatch,
                         get_model=lambda name: types.SimpleNamespace(make_layout=lambda: jlayout))
    monkeypatch.setattr(script, "pl", types.SimpleNamespace(**{**vars(script.pl), "pallas_call": pallas_call}))
    monkeypatch.setattr(script, "jnp", types.SimpleNamespace(int32=np.int32, zeros=lambda *a, **k: None))
    monkeypatch.setattr(script.jax, "ShapeDtypeStruct", lambda *a, **k: None)
    _, staged_bytes = script.build(variant, 1)
    kernel = recorded["kernel"]
    cells = dict(zip(kernel.__code__.co_freevars, (c.cell_contents for c in kernel.__closure__)))
    return cells, staged_bytes


def staged_rows(groups, sel, strides, n_chunks):
    """Rows of each selected group's planes that the TPU's chunks stage,
    clipped to the plane (the chunks' padding reaches past it)."""
    rows = []
    for gi in sel:
        off, n, d = groups[gi]
        assert strides[gi] * n_chunks[gi] >= n  # the chunks cover the plane
        for j in range(d):
            covered = off + j * n + np.arange(strides[gi] * n_chunks[gi])
            rows.append(covered[covered < off + j * n + n])
    return np.concatenate(rows) if rows else np.zeros(0, np.int64)


@pytest.mark.parametrize("variant", p6.VARIANTS)
def test_replay_reads_the_rows_the_script_stages(monkeypatch, dvbs2, variant):
    layout, jlayout = dvbs2
    cells, staged_bytes = script_program(monkeypatch, jlayout, p6.TPU_VARIANT[variant])
    program = p6.replay_program(layout, variant)
    got = p6.rows_read(program)
    # The groups: the same (offset, nodes, degree) selected, in the same order.
    assert [cells["cn_groups"][i] for i in cells["cn_sel"]] == [tuple(g) for g in program.cn_groups.tolist()]
    assert [cells["vn_groups"][i] for i in cells["vn_sel"]] == [tuple(g[:3]) for g in program.vn_groups.tolist()]
    cn = staged_rows(cells["cn_groups"], cells["cn_sel"], cells["cn_strides"], cells["cn_nchunks"])
    assert np.array_equal(np.sort(cn), np.sort(got["cn"]))
    # The TPU stages a degree-1 node's message; K3 and the replay forward its
    # channel value without reading it.
    vn_sel = [i for i in cells["vn_sel"] if cells["vn_groups"][i][2] > 1]
    vn = staged_rows(cells["vn_groups"], vn_sel, cells["vn_strides"], cells["vn_nchunks"])
    assert np.array_equal(np.sort(vn), np.sort(got["vn"]))
    if variant != "staged":  # depth4 stages no channel
        assert cells["use_chv"] == program.chv
        assert cells["do_write"] == program.write
    if program.chv:
        chv = [cells["vn_node_offsets"][i] + np.arange(cells["vn_groups"][i][1]) for i in cells["vn_sel"]]
        assert np.array_equal(np.sort(np.concatenate([np.zeros(0, int), *chv])), np.sort(got["chg"]))
    for rows in got.values():
        assert len(np.unique(rows)) == len(rows)  # once each
    assert staged_bytes >= (len(got["cn"]) + len(got["vn"])) * 128 * 4


def test_view_traffic_of_a_dvbs2_body(dvbs2):
    layout, _ = dvbs2
    exact = p6.StageReplay(layout, "exact")
    # Both views read and written, less the degree-1 node's unread message,
    # and the channel plane read: about 995 MB, 0.297 ms at 3.35 TB/s.
    assert exact.bytes_per_body(1024) == (4 * 226_799 - 1 + 64_800) * 1024
    assert exact.bytes_per_body(1024) / 3.35e12 * 1e3 == pytest.approx(0.297, abs=5e-4)
    assert p6.StageReplay(layout, "nowrite").bytes_per_body(1024) == (2 * 226_799 - 1 + 64_800) * 1024
    assert exact.stage_planes == 9 and p6.StageReplay(layout, "nochv").stage_planes == 8
    units = p6.staged_units(exact.program.vn_groups)
    assert len(units) == 1 + 1350 + 810 + 540  # 24-node units of 1, 32399, 19440, 12960 nodes


@pytest.fixture(scope="module")
def ira():
    """A small DVB-S2-like IRA code: a 1-node group of each kind (the
    parity chain's first check and last variable) beside large ones."""
    H = dvbs2_like_parity_check(480, 240, seed=9)
    ck, vk = dvbs2_layout_node_keys(480, 240)
    ek_csr, ek_csc = dvbs2_layout_edge_keys(H, 240)
    return DecodeLayout.from_graph(TannerGraph.from_check_matrix(H), cn_node_key=ck, vn_node_key=vk,
                                   cn_edge_key=ek_csr, vn_edge_key=ek_csc)


def replay_loop(program, layout, views, bodies):
    """The replay with a loop over nodes (numpy, every tile and column at
    once): output k of a node is the XOR of its other inputs XOR k."""
    A, B, chg = (x.numpy().copy() for x in (views.A, views.B, views.chg))
    sums = views.sums.numpy().astype(np.int64)
    cn_route, vn_route = layout.cn_to_vn_row, layout.vn_to_cn_row
    for _ in range(bodies):
        for off, n, d, node_off in program.vn_groups.tolist():
            for node in range(n):
                ch = chg[:, node_off + node] if program.chv else np.zeros_like(chg[:, 0])
                rows = [off + k * n + node for k in range(d)] if d > 1 else []
                if not program.write:
                    sums += sum(B[:, r].astype(np.int64).sum(1) for r in rows)
                    sums += ch.astype(np.int64).sum(1) if program.chv else 0
                    continue
                if d == 1:
                    A[:, vn_route[off + node]] = ch
                    continue
                x = ch.copy()
                for r in rows:
                    x ^= B[:, r]
                for k, r in enumerate(rows):
                    A[:, vn_route[r]] = x ^ B[:, r] ^ k
        for off, n, d in program.cn_groups.tolist():
            for node in range(n):
                rows = [off + k * n + node for k in range(d)]
                if not program.write:
                    sums += sum(A[:, r].astype(np.int64).sum(1) for r in rows)
                    continue
                x = np.zeros_like(A[:, 0])
                for r in rows:
                    x ^= A[:, r]
                for k, r in enumerate(rows):
                    B[:, cn_route[r]] = x ^ A[:, r] ^ k
    return A, B, ((sums & 0xFFFFFFFF).astype(np.uint32).view(np.int32))


@pytest.mark.parametrize("variant", p6.VARIANTS)
def test_replay_plain_matches_a_numpy_loop(ira, variant):
    views = p6.ReplayViews.random(ira, 256, "cpu", seed=3)
    replay = p6.StageReplay(ira, variant)
    want = replay_loop(replay.program, ira, views, bodies=2)
    replay(views, bodies=2)
    assert [np.array_equal(g.numpy(), w) for g, w in zip((views.A, views.B, views.sums), want)] == [True] * 3
    assert p6.launches[variant] == 0
    if variant == "nosmall":  # the 1-node groups of this code are skipped
        assert len(replay.program.vn_groups) == 2 and len(replay.program.cn_groups) == 1


def test_staged_replays_exact(ira):
    views = p6.ReplayViews.random(ira, 128, "cpu", seed=4)
    other = views.clone()
    p6.StageReplay(ira, "exact")(views, bodies=3)
    p6.StageReplay(ira, "staged")(other, bodies=3)
    assert views.equal(other)
    units = p6.staged_units(p6.replay_program(ira, "exact").vn_groups, piece=50)
    assert units.tolist() == [[0, 0], [1, 0], [1, 50], [1, 100], [1, 150], [1, 200],
                              [2, 0], [2, 50], [2, 100], [2, 150], [2, 200]]


WIDE_THREADS, SPLIT_DEGREE = 256, 8  # csrc/hbm_wide.cuh's kThreads and kSplitDegree


def row_items(bt, v, grid, block, tid):
    """``hbm_wide::row_items``: a thread's first node row, node step and first
    column at ``v`` columns an item in blocks of whole rows."""
    lanes = bt // v
    threads = WIDE_THREADS // lanes * lanes
    t = block * threads + tid
    return t // lanes, grid * (threads // lanes), t % lanes * v


def wide_items(bt, v, grid, n):
    """Every (node, first column) the threads of a ``grid``-block wide pass
    visit in a group of ``n`` nodes, with repeats."""
    lanes = bt // v
    threads = WIDE_THREADS // lanes * lanes
    out = []
    for block in range(grid):
        for tid in range(threads):
            node, step, c0 = row_items(bt, v, grid, block, tid)
            out += [(m, c0) for m in range(node, n, step)]
    return out


@pytest.mark.parametrize("v", [8, 4])
@pytest.mark.parametrize("grid", [1, 3, 17])
def test_wide_pass_visits_every_node_column_once(v, grid):
    for n in (1, 5, 37, 200):
        items = wide_items(p6.BATCH_TILE, v, grid, n)
        assert sorted(items) == [(m, c) for m in range(n) for c in range(0, p6.BATCH_TILE, v)]


def wide_replay(program, views, routes, bodies):
    """P6's kernel as a plain model: the views as 32-bit words of four
    columns; per group of the low range (degree <= 8) and then the high
    one, each node's input rows loaded whole, output k = the XOR of every
    input word (and the channel's) ^ input k ^ k in each byte, stored at its
    route; ``nowrite`` sums the bytes of the words it reads (as ``__dp4a``
    with 0x01010101)."""
    A, B, chg = (x.numpy().view(np.uint32).copy() for x in (views.A, views.B, views.chg))
    sums = views.sums.numpy().astype(np.int64)
    cn_route, vn_route = (routes[k].numpy() for k in ("cn_route", "vn_route"))

    def byte_sum(words):
        return sum(((words >> s) & 0xFF).astype(np.int64).sum((1, 2)) for s in (0, 8, 16, 24))

    def ranged(groups):
        return [g for hi in (False, True) for g in groups.tolist() if (g[2] > SPLIT_DEGREE) == hi]

    for _ in range(bodies):
        for off, n, d, node in ranged(program.vn_groups):
            ch = chg[:, node:node + n] if program.chv else np.zeros_like(chg[:, :n])
            rows = B[:, off:off + d * n].reshape(len(B), d, n, -1) if d > 1 else np.zeros((len(B), 0, n, 32), np.uint32)
            if not program.write:
                sums += byte_sum(ch) + sum(byte_sum(rows[:, k]) for k in range(rows.shape[1]))
                continue
            if d == 1:
                A[:, vn_route[off:off + n]] = ch
                continue
            x = ch ^ np.bitwise_xor.reduce(rows, axis=1)
            for k in range(d):
                A[:, vn_route[off + k * n:off + (k + 1) * n]] = x ^ rows[:, k] ^ np.uint32(k * 0x01010101)
        for off, n, d in ranged(program.cn_groups):
            rows = A[:, off:off + d * n].reshape(len(A), d, n, -1)
            if not program.write:
                sums += sum(byte_sum(rows[:, k]) for k in range(d))
                continue
            x = np.bitwise_xor.reduce(rows, axis=1)
            for k in range(d):
                B[:, cn_route[off + k * n:off + (k + 1) * n]] = x ^ rows[:, k] ^ np.uint32(k * 0x01010101)
    wrap = (sums & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    return A.view(np.uint8), B.view(np.uint8), wrap


@pytest.mark.parametrize("variant", p6.VARIANTS)
def test_wide_replay_model_equals_the_plain_replay(ira, variant):
    views = p6.ReplayViews.random(ira, 256, "cpu", seed=6)
    replay = p6.StageReplay(ira, variant)
    routes = {k: torch.as_tensor(a) for k, a in (("cn_route", ira.cn_to_vn_row), ("vn_route", ira.vn_to_cn_row))}
    want = wide_replay(replay.program, views, routes, bodies=2)
    replay(views, bodies=2)
    assert [np.array_equal(g.numpy(), w) for g, w in zip((views.A, views.B, views.sums), want)] == [True] * 3
    # One launch a pass on this code, as on DVB-S2: no degree above the split.
    assert p6.max_degree(replay.program.cn_groups) <= SPLIT_DEGREE
    assert p6.max_degree(replay.program.vn_groups) <= SPLIT_DEGREE
    assert p6.max_degree(replay.program.vn_groups[:0]) == 0


# -- refusals ---------------------------------------------------------------------

def test_wrappers_refuse_what_the_kernels_do_not_take(ira):
    with pytest.raises(ValueError, match="unknown variant"):
        p5.stage_schedule("when")
    with pytest.raises(ValueError, match="int32"):
        p5.StageChunks("base", rows=SMALL_ROWS, piece_rows=4, **SMALL)(torch.zeros((SMALL_ROWS, 128)))
    with pytest.raises(ValueError, match="whole number of pieces"):
        p5.StageChunks("base", piece_rows=48)
    with pytest.raises(ValueError, match="past the source"):
        p5.StageChunks("unalign", rows=p5.D * p5.PLANE)
    with pytest.raises(ValueError, match="unknown variant"):
        p6.replay_program(ira, "outviews")
    with pytest.raises(ValueError, match="whole tiles"):
        p6.ReplayViews.random(ira, 100, "cpu")
    views = p6.ReplayViews.random(ira, 128, "cpu")
    views.B = views.B[:, 1:]
    with pytest.raises(ValueError, match="B must be uint8"):
        p6.StageReplay(ira, "exact")(views)


def test_a_cuda_request_without_a_card_raises(ira, monkeypatch):
    """A tensor off the CPU goes to the kernel, which needs a CUDA device."""
    meta = torch.zeros((SMALL_ROWS, 128), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda device"):
        p5.StageChunks("base", rows=SMALL_ROWS, piece_rows=4, **SMALL)(meta, blocks=2)
    views = p6.ReplayViews(*(torch.empty(x.shape, dtype=x.dtype, device="meta")
                             for x in vars(p6.ReplayViews.random(ira, 128, "cpu")).values()))
    with pytest.raises(ValueError, match="cuda device"):
        p6.StageReplay(ira, "exact")(views)
    assert sum(p5.launches.values()) + sum(p6.launches.values()) == 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for measure in (probes.measure_stage, probes.measure_replay):
        with pytest.raises(RuntimeError, match="CUDA"):
            measure()


def test_the_probe_entry_point_refuses_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli_probes.PROBES[-2:] == ("p5", "p6")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli_probes.main(["--only", "p5,p6", "--out", str(tmp_path / "p.json")])
    assert not (tmp_path / "p.json").exists()
