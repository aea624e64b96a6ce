"""The fused IB decoder K1's schedule as a plain per-pass model.

K1 (``csrc/ib_lut_fused.cu``) decodes one tile per CTA. A thread keeps V
codeword columns (4 where 4 divides the tile, else 1) for the whole decode
and walks each pass flat over all its degree groups, q nodes at a time.
Where the tables take 4 bits a message and the carve fits
(``kernel_shared_bytes``), the views hold 4 bits a message, the routes are
read as uint16 from device memory, and the passes' pairwise tables are
copied per lane (``lane_words``): lane l's copy of entry x at byte position
q at (q // 4) * 32768 + 128 x + 4 l + q % 4, the CN pass's slot s at
position s and the VN pass's at 15 - s, each stage rewriting whole groups.
Else the routes are read as uint16 from shared memory where they fit, else
as int32, and the pairwise tables are one byte copy per block, slot l at
l * slot. Entry (a, b) is a * stride + b (stride |T_ch| for the iteration-0
CN tables, |T| otherwise). A body is a VN pass and a CN pass that counts
the checks of odd input parity per column; with early exit the tile leaves
after the barrier that follows the CN pass when no count is set. The
decision folds the channel and every message with the VN tables of the last
iteration, one copy per block.

:func:`k1_passes` runs that schedule pass by pass, tile by tile, with the
port's node folds (``ops/lut_fold.py``) reading K1's own table and route
arrays (``FusedIBDecoder.host_arrays``) through K1's addressing. It must
equal the plain twin ``ib_lut_decode_tiled``, and on the 96-variable QC code
the JAX package's ``FusedIBDecoder`` in interpret mode. Inputs are made with
numpy from a seed; every comparison is exact.

On the per-lane path a tile may run on a thread-block cluster of c CTAs
(``cluster_size``): rank r walks its span of the checks and of the
variables (``cluster_split``) and holds only their view rows, and every
routed output goes to the rank that the packed route names
(``cluster_arrays``). The model then keeps one memory per rank, every row
it does not hold out of range, so a read of a row that its rank was never
sent fails.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from informationbottleneckdecodingldpc_tpu.codes import TannerGraph
from informationbottleneckdecodingldpc_tpu.codes.random_codes import (
    regular_qc_parity_check,
)
from informationbottleneckdecodingldpc_tpu.construct import build_decoder_config
from informationbottleneckdecodingldpc_tpu.decode import (
    DecodeLayout as JaxLayout,
    DeviceTrellis as JaxTrellis,
    ib_lut_decode as jax_ib_lut_decode,
)
from informationbottleneckdecodingldpc_tpu.kernels import (
    FusedIBDecoder as JaxFusedIBDecoder,
)
from informationbottleneckdecodingldpc_torch.channel import (
    build_quantizer_tables,
    device_tables,
    sample_clusters_from_uniform,
    sigma2_from_ebn0_db,
)
from informationbottleneckdecodingldpc_torch.construct import (
    DecoderConfig,
    TrellisTables,
)
from informationbottleneckdecodingldpc_torch.decode import DecodeLayout
from informationbottleneckdecodingldpc_torch.decode.common import DecodeResult
from informationbottleneckdecodingldpc_torch.kernels import ib_lut_fused as k1
from informationbottleneckdecodingldpc_torch.kernels.ib_lut_fused import (
    FusedIBDecoder,
    ib_lut_decode_tiled,
    mean_iterations,
)
from informationbottleneckdecodingldpc_torch.models import get_model
from informationbottleneckdecodingldpc_torch.ops.lut_fold import (
    cn_lut_leave_one_out,
    vn_lut_full_fold,
    vn_lut_leave_one_out,
)

CONFIGS = "results/configs"


# -- the schedule -------------------------------------------------------------


def k1_walk(layout, batch_tile: int, kind: str, span: tuple[int, int] | None = None
            ) -> dict[str, np.ndarray]:
    """K1's nodes of one pass ('cn', 'vn' or 'decide') in the order each
    thread meets them: per record the thread, its first column c0, the
    group and the node's index in its group; on a cluster, the nodes of the
    CTA's ``span`` (flat indices lo .. hi - 1)."""
    v = k1.columns_per_thread(batch_tile)
    lanes = batch_tile // v
    threads = k1.threads_per_cta(batch_tile)
    q = threads // lanes
    groups = layout.cn_groups if kind == "cn" else layout.vn_groups
    nodes = np.asarray(
        [(gi, ln) for gi, g in enumerate(groups) for ln in range(g.num_nodes)], dtype=np.int64
    )
    lo, hi = span if span is not None else (0, len(nodes))
    rec = []
    for t in range(threads):
        # One division per thread and launch; the nodes step by q, flat
        # over the groups.
        mine = np.arange(lo + t // lanes, hi, q)
        rec.append(np.column_stack([np.full((len(mine), 2), [t, t % lanes * v]), nodes[mine]]))
    rec = np.concatenate(rec).reshape(-1, 4)
    return dict(thread=rec[:, 0], c0=rec[:, 1], group=rec[:, 2], ln=rec[:, 3])


# -- the model ----------------------------------------------------------------


class SlotLut:
    """One pairwise LUT in a slot of K1's shared tables, read with K1's
    addressing: a * stride + b."""

    def __init__(self, slot: torch.Tensor, stride: int):
        self.slot, self.stride = slot, stride

    def __getitem__(self, ab):
        a, b = ab
        return self.slot[a * self.stride + b]


LANE_GROUP = k1.LANE_ENTRIES * 128  # bytes of one group of the per-lane tables


def lane_position(kind: str, slot: int) -> int:
    """The byte position of a pass's slot in the per-lane tables."""
    return slot if kind == "cn" else k1.LANE_POSITIONS - 1 - slot


class LaneLut:
    """One pairwise LUT of the per-lane tables ``mem`` (bytes), read with
    K1's addressing: the thread's lane (``lane`` [R, 1]), entry
    a * stride + b, the slot's byte position."""

    def __init__(self, mem: torch.Tensor, position: int, stride: int, lane: torch.Tensor):
        self.mem, self.stride, self.lane = mem, stride, lane
        self.const = position // 4 * LANE_GROUP + position % 4

    def __getitem__(self, ab):
        a, b = ab
        return self.mem[a * (128 * self.stride) + (4 * self.lane | b << 7) + self.const]


def spread_stage(mem: torch.Tensor, stage: np.ndarray, group0: int, groups: int,
                 row_bytes: int) -> torch.Tensor:
    """A stage as ``lane_words`` holds it, spread as K1's spread_stage does:
    its groups' words stored for the 32 lanes (entry x of group g at
    g * 32768 + 128 x, lane l's word 4 l bytes further), and its alignment
    rows, which it returns as K1 stages them ([degree, T])."""
    words = stage[: groups * k1.LANE_ENTRIES].astype("<u4")
    lanes = np.repeat(words, 32)
    as_bytes = torch.as_tensor(lanes.view(np.uint8).astype(np.int64))
    start = group0 * LANE_GROUP
    mem[start : start + as_bytes.numel()] = as_bytes
    rows = stage[groups * k1.LANE_ENTRIES :].astype("<u4").view(np.uint8)[:row_bytes]
    return torch.as_tensor(rows.astype(np.int64))


FAR = 1 << 20  # a row a rank does not hold: out of range of every table


def k1_passes(dec: FusedIBDecoder, clusters: torch.Tensor, cluster: int = 1):
    """K1's passes in plain torch, one zero-padded tile at a time, each tile
    on ``cluster`` CTAs: the decode result and each tile's passes in order."""
    lay, bt = dec.layout, dec.batch_tile
    t = dec.tables
    T, Tch = t.cardinality_t_decoder, t.cardinality_t_channel
    host = dec.host_arrays()
    a = {k: torch.as_tensor(v.astype(np.int64)) for k, v in host.items()}
    carve = k1.kernel_shared_bytes(lay, bt, Tch, T)
    assert ("lane_cn" in host) == carve.lanes
    if cluster > 1:  # the packed routes: the row, and the rank that holds it
        assert carve.lanes
        cl = k1.cluster_arrays(lay, cluster)
        split = cl["split"].reshape(2, cluster + 1)
        packed = {k: torch.as_tensor(cl[f"{k}_route_cl"].astype(np.int64)) for k in ("cn", "vn")}
        routes = {k: r & 0xFFFF for k, r in packed.items()}
        owners = {k: r >> 16 for k, r in packed.items()}
        assert all(torch.equal(routes[k], a[f"{k}_route16"]) for k in ("cn", "vn"))
    else:
        split = np.asarray([[0, sum(g.num_nodes for g in lay.cn_groups)], [0, lay.n_vars]])
        if carve.shared_routes or carve.lanes:  # the kernel reads the uint16 copies
            routes = {"cn": a["cn_route16"], "vn": a["vn_route16"]}
        else:
            routes = {"cn": a["cn_route"], "vn": a["vn_route"]}
        owners = {k: torch.zeros_like(r) for k, r in routes.items()}
    if carve.lanes:
        mem = torch.zeros(k1.LANE_BYTES, dtype=torch.int64)
        cn_groups, vn_group0 = k1.lane_groups(lay)
    v = k1.columns_per_thread(bt)
    spans = {"cn": split[0], "vn": split[1], "decide": split[1]}
    walks = {(r, kind): k1_walk(lay, bt, kind, (spans[kind][r], spans[kind][r + 1]))
             for r in range(cluster) for kind in spans}
    node_offsets = np.cumsum([0] + [g.num_nodes for g in lay.vn_groups])

    def luts(kind, stage, n, stride, thread):
        if not carve.lanes:
            return [SlotLut(s, stride) for s in stage[:n]]
        lane = torch.as_tensor(thread % 32)[:, None]
        return [LaneLut(mem, lane_position(kind, s), stride, lane) for s in range(n)]

    def records(r, kind, gi):
        w = walks[r, kind]
        sel = w["group"] == gi
        ln = torch.as_tensor(w["ln"][sel])
        cols = torch.as_tensor(w["c0"][sel])[:, None] + torch.arange(v)  # [R, V]
        return ln, cols, w["thread"][sel]

    def write(dst, kind, edges, cols, values):
        """Routed outputs of rows ``edges`` into the view of the rank that
        holds each route's row."""
        if carve.lanes:  # a message is 4 bits of the view
            assert bool((values < 16).all())
        rows, owner = routes[kind][edges], owners[kind][edges]
        for o in range(cluster):
            sel = owner == o
            dst[o][rows[sel][:, None], cols[sel]] = values[sel]

    def cn_pass(r, src, dst, stage, stride, match, unsat):
        for gi, g in enumerate(lay.cn_groups):
            ln, cols, thread = records(r, "cn", gi)
            rows = [g.offset + k * g.num_nodes + ln for k in range(g.degree)]
            m = torch.stack([src[r][e[:, None], cols] for e in rows])  # [d, R, V]
            if unsat is not None:
                odd = ((m < T // 2).sum(0) % 2).reshape(-1).to(torch.int32)
                unsat.index_add_(0, cols.reshape(-1), odd)
            out = cn_lut_leave_one_out(m, luts("cn", stage, g.degree - 2, stride, thread))
            for k, e in enumerate(rows):
                write(dst, "cn", e, cols, match[g.degree - 1][out[k]])

    def vn_pass(r, src, dst, chg, stage, match):
        for gi, g in enumerate(lay.vn_groups):
            d = g.degree
            ln, cols, thread = records(r, "vn", gi)
            ch = chg[r][(node_offsets[gi] + ln)[:, None], cols]
            rows = [g.offset + k * g.num_nodes + ln for k in range(d)]
            m = torch.stack([src[r][e[:, None], cols] for e in rows])
            vs = luts("vn", stage, max(d - 1, 1), T, thread)
            out = vn_lut_leave_one_out(ch, m, vs[0], vs[1:])
            for k in range(d):  # degree 1 forwards the channel, unaligned
                val = out[k] if d == 1 else match[d - 1][out[k]]
                write(dst, "vn", rows[k], cols, val)

    def stage(kind, i):
        """The tables of a pass of iteration i, staged during the pass before."""
        match = a[f"match_{kind}"][i]
        if carve.lanes:
            g0, groups = (0, cn_groups) if kind == "cn" else (vn_group0, 4 - vn_group0)
            rows = spread_stage(mem, host[f"lane_{kind}"][i], g0, groups, match.numel())
            match = rows.reshape(match.shape)
        return a[f"{kind}_tab"][i], match

    def decide(r, src, chg, stage, out):
        for gi, g in enumerate(lay.vn_groups):
            ln, cols, _ = records(r, "decide", gi)
            node = node_offsets[gi] + ln
            ch = chg[r][node[:, None], cols]
            m = torch.stack([src[r][(g.offset + k * g.num_nodes + ln)[:, None], cols]
                             for k in range(g.degree)])
            vs = [SlotLut(s, T) for s in stage[: g.degree]]  # one copy per block
            out[a["node_var"][node][:, None], cols] = vn_lut_full_fold(ch, m, vs[0], vs[1:])

    def seed(x):
        """Each rank's views and channel: the CN-view rows of its checks and
        the channel rows of its variables seeded, every other row out of
        range."""
        A = torch.full((cluster, lay.n_edges, bt), FAR, dtype=torch.int64)
        chg = torch.full((cluster, lay.n_vars, bt), FAR, dtype=torch.int64)
        for r in range(cluster):
            w = walks[r, "cn"]
            for gi, g in enumerate(lay.cn_groups):
                ln = torch.as_tensor(w["ln"][w["group"] == gi])
                for k in range(g.degree):
                    rows = g.offset + k * g.num_nodes + ln
                    A[r, rows] = x[a["seed_var"][rows]]
            lo, hi = split[1, r], split[1, r + 1]
            chg[r, lo:hi] = x[a["node_var"][lo:hi]]
        return A, torch.full_like(A, FAR), chg

    batch = clusters.shape[1]
    pad = (-batch) % bt
    padded = torch.nn.functional.pad(clusters.to(torch.int64), (0, pad))
    outs, unsats, per_codeword, traces = [], [], [], []
    ranks = range(cluster)
    for b0 in range(0, batch + pad, bt):
        A, B, chg = seed(padded[:, b0 : b0 + bt])
        tc, mc = stage("cn", 0)
        tv, mv = stage("vn", 0)  # staged during the next pass: the other bytes
        for r in ranks:
            cn_pass(r, A, B, tc, Tch, mc, None)
        unsat = torch.zeros((cluster, 2, bt), dtype=torch.int32)
        trace, iters = ["cn0"], 0
        for i in range(dec.imax - 1):
            tc, mc = stage("cn", i + 1)
            for r in ranks:
                vn_pass(r, B, A, chg, tv, mv)
            tv, mv = stage("vn", i + 1)
            unsat[:, (i + 1) & 1] = 0
            for r in ranks:
                cn_pass(r, A, B, tc, T, mc, unsat[r, i & 1])
            trace += ["vn", "cn"]
            iters = i + 1
            # The barrier's OR, over the block or the cluster.
            if dec.early_exit and not bool((unsat[:, i & 1] > 0).any()):
                break
        out = torch.zeros((lay.n_vars, bt), dtype=torch.int64)
        for r in ranks:
            decide(r, B, chg, tv, out)
        outs.append(out)
        unsats.append(torch.ones(bt, dtype=torch.int32) if iters == 0
                      else unsat[:, (iters - 1) & 1].sum(0, dtype=torch.int32))
        per_codeword.append(torch.full((bt,), iters, dtype=torch.int32))
        traces.append(trace)
    result = DecodeResult(
        outputs=torch.cat(outs, dim=1)[:, :batch].to(torch.int32),
        iterations=mean_iterations(torch.cat(per_codeword)[:batch]),
        unsatisfied=torch.cat(unsats)[:batch],
    )
    return result, traces


# -- fixtures -----------------------------------------------------------------


def _qc96_tables(t_decoder: int):
    cfg = build_decoder_config(
        design_ebn0_db=2.0,
        cardinality_y_channel=400,
        cardinality_t_channel=t_decoder,
        cardinality_t_decoder=t_decoder,
        i_max=6,
        d_v=3,
        d_c=6,
    )
    return TrellisTables(**dataclasses.asdict(cfg.tables)), cfg.tables


@pytest.fixture(scope="module")
def qc96():
    g = TannerGraph.from_check_matrix(regular_qc_parity_check(96, 3, 6, seed=7))
    return DecodeLayout.from_graph(g), JaxLayout.from_graph(g), {16: _qc96_tables(16)}


@pytest.fixture(scope="module")
def qc96_t32(qc96):
    return _qc96_tables(32)


def _clusters(ebn0_db, t_channel, n_vars, batch, seed):
    qt = build_quantizer_tables(sigma2_from_ebn0_db(ebn0_db, 0.5), 3.0, t_channel, 400)
    u = np.random.default_rng(seed).random((n_vars, batch), dtype=np.float32)
    return sample_clusters_from_uniform(
        device_tables(qt, "cpu").cdf,
        torch.as_tensor(u),
        torch.zeros((n_vars, batch), dtype=torch.int32),
    )


def _same(got, want) -> bool:
    return (
        np.array_equal(got.outputs.numpy(), np.asarray(want.outputs))
        and np.array_equal(got.unsatisfied.numpy(), np.asarray(want.unsatisfied))
        and float(got.iterations) == float(want.iterations)
    )


def _jax(jlayout, jtables, ch, **kw):
    return JaxFusedIBDecoder(jlayout, jtables, interpret=True, **kw)(jnp.asarray(ch.numpy()))


# -- the model against the twin and the JAX kernel ----------------------------


@pytest.mark.parametrize("early_exit", [True, False])
@pytest.mark.parametrize("max_iters", [1, 2, 3])
def test_k1_passes_match_twin_and_jax_kernel_at_the_loop_bounds(qc96, early_exit, max_iters):
    """i_max 1 (no body: the decision of the iteration-0 CN pass, unsat 1),
    2 (one body) and 3 (an exit test after each body), on three tiles of 8,
    the last padded, at a level where tiles leave early."""
    layout, jlayout, tabs = qc96
    tables, jtables = tabs[16]
    ch = _clusters(6.0, 16, layout.n_vars, 20, seed=max_iters)
    dec = FusedIBDecoder(layout, tables, max_iters=max_iters, early_exit=early_exit, batch_tile=8)
    got, traces = k1_passes(dec, ch)
    assert _same(got, ib_lut_decode_tiled(layout, dec.trellis("cpu"), ch, 8, max_iters, early_exit))
    assert _same(got, _jax(jlayout, jtables, ch, max_iters=max_iters, early_exit=early_exit,
                           batch_tile=8))
    for trace in traces:
        assert trace[0] == "cn0" and len(trace) <= 1 + 2 * (max_iters - 1)
    if max_iters == 1:
        assert torch.equal(got.unsatisfied, torch.ones(20, dtype=torch.int32))


def test_k1_passes_leave_after_odd_even_and_no_bodies(qc96):
    """Three tiles of 8 drawn so that the twin's per-tile decoders leave
    after 2 and 3 bodies and run all 5; the model leaves after the same
    bodies and equals the twin and the JAX kernel."""
    layout, jlayout, tabs = qc96
    tables, jtables = tabs[16]
    ch = torch.cat([_clusters(db, 16, layout.n_vars, 8, seed=s)
                    for db, s in ((6.0, 0), (6.0, 3), (2.0, 0))], dim=1)
    dec = FusedIBDecoder(layout, tables, batch_tile=8)
    got, traces = k1_passes(dec, ch)
    assert [t.count("vn") for t in traces] == [2, 3, 5]
    assert _same(got, ib_lut_decode_tiled(layout, dec.trellis("cpu"), ch, 8))
    assert _same(got, _jax(jlayout, jtables, ch, early_exit=True, batch_tile=8))


@pytest.mark.parametrize("batch, batch_tile", [(21, 8), (21, 4), (13, 5), (7, 1)])
def test_k1_passes_pad_the_last_tile_and_take_one_column_per_thread(qc96, batch, batch_tile):
    """A padded last tile; tiles that 4 divides take 4 columns per thread,
    others one."""
    layout, jlayout, tabs = qc96
    tables, jtables = tabs[16]
    ch = _clusters(5.0, 16, layout.n_vars, batch, seed=batch_tile)
    dec = FusedIBDecoder(layout, tables, batch_tile=batch_tile)
    got, _ = k1_passes(dec, ch)
    assert k1.columns_per_thread(batch_tile) == (4 if batch_tile % 4 == 0 else 1)
    assert _same(got, ib_lut_decode_tiled(layout, dec.trellis("cpu"), ch, batch_tile))
    assert _same(got, _jax(jlayout, jtables, ch, early_exit=True, batch_tile=batch_tile))


@pytest.mark.parametrize("early_exit", [True, False])
def test_k1_passes_with_byte_tables_at_t32(qc96, qc96_t32, early_exit):
    """|T| = 32 (1 KB table slots). Against the twin and, per tile, the JAX
    whole-batch decoder (the JAX kernel's interpreter takes minutes at
    |T| = 32)."""
    layout, jlayout, _ = qc96
    tables, jtables = qc96_t32
    ch = _clusters(5.0, 32, layout.n_vars, 24, seed=5)
    dec = FusedIBDecoder(layout, tables, early_exit=early_exit, batch_tile=8)
    got, traces = k1_passes(dec, ch)
    assert _same(got, ib_lut_decode_tiled(layout, dec.trellis("cpu"), ch, 8,
                                          early_exit=early_exit))
    jtrellis = JaxTrellis.from_tables(jtables)
    for t, b0 in enumerate(range(0, 24, 8)):
        tile = jnp.asarray(ch[:, b0 : b0 + 8].numpy())
        want = jax_ib_lut_decode(jlayout, jtrellis, tile, early_exit=early_exit)
        assert np.array_equal(got.outputs[:, b0 : b0 + 8].numpy(), np.asarray(want.outputs))
        assert np.array_equal(got.unsatisfied[b0 : b0 + 8].numpy(), np.asarray(want.unsatisfied))
        assert traces[t].count("vn") == int(want.iterations)


def test_k1_passes_without_alignment(qc96):
    layout, jlayout, tabs = qc96
    tables, jtables = tabs[16]
    ch = _clusters(5.0, 16, layout.n_vars, 16, seed=11)
    dec = FusedIBDecoder(layout, tables, use_matching=False, batch_tile=8)
    got, _ = k1_passes(dec, ch)
    assert _same(got, ib_lut_decode_tiled(layout, dec.trellis("cpu"), ch, 8))


@pytest.mark.parametrize(
    "config, ebn0_db, max_iters, early_exit",
    [("wlan_T16_0.8", 6.0, 4, True), ("wlan_T16_0.8", 0.8, 3, False), ("wlan_T32_0.6", 0.8, 2, True)],
)
def test_k1_passes_on_wlan_at_its_default_tile(config, ebn0_db, max_iters, early_exit):
    """WLAN at its default tile of 16: 4 columns per thread, 640 threads;
    at |T| = 16 the per-lane tables and 4-bit views (routes uint16 from
    device memory), at |T| = 32 one table copy a block and the routes uint16
    in shared memory; equal to the twin."""
    layout = get_model("wlan-1296").make_layout()
    tables = DecoderConfig.load(f"{CONFIGS}/{config}.npz").tables
    dec = FusedIBDecoder(layout, tables, max_iters=max_iters, early_exit=early_exit)
    assert dec.batch_tile == 16 and k1.threads_per_cta(16) == 640
    carve = k1.kernel_shared_bytes(layout, 16, tables.cardinality_t_channel,
                                   tables.cardinality_t_decoder)
    t16 = tables.cardinality_t_decoder == 16
    assert (carve.lanes, carve.shared_routes) == (t16, not t16)
    ch = _clusters(ebn0_db, tables.cardinality_t_channel, layout.n_vars, 20, seed=3)
    got, _ = k1_passes(dec, ch)
    assert _same(got, ib_lut_decode_tiled(layout, dec.trellis("cpu"), ch, 16, max_iters,
                                          early_exit))


def test_k1_passes_on_regular_8000_read_int32_routes():
    """Regular (3,6) N=8000 at its default tile of 4: the routes do not fit
    beside the views, so the kernel reads them as int32."""
    layout = get_model("regular-3-6-8000").make_layout()
    tables = DecoderConfig.load(f"{CONFIGS}/regular_T16_1.05.npz").tables
    dec = FusedIBDecoder(layout, tables, max_iters=3, early_exit=True)
    assert dec.batch_tile == 4
    assert k1.kernel_shared_bytes(layout, 4, 16, 16) == (225_968, False, False)
    ch = _clusters(1.2, 16, layout.n_vars, 6, seed=4)
    got, _ = k1_passes(dec, ch)
    assert _same(got, ib_lut_decode_tiled(layout, dec.trellis("cpu"), ch, 4, 3))


@pytest.mark.parametrize("cluster", [2, 3, 4])
@pytest.mark.parametrize("early_exit", [True, False])
def test_k1_passes_on_clusters_match_the_twin(qc96, cluster, early_exit):
    """Tiles of 8 on clusters of 2, 3 and 4 CTAs, each rank holding only its
    nodes' rows: three tiles that leave after 2 and 3 bodies and run all 5,
    and a padded last tile; equal to the twin and to one CTA a tile."""
    layout, _, tabs = qc96
    tables, _ = tabs[16]
    ch = torch.cat([_clusters(db, 16, layout.n_vars, n, seed=s)
                    for db, s, n in ((6.0, 0, 8), (6.0, 3, 8), (2.0, 0, 8), (5.0, 1, 5))], dim=1)
    dec = FusedIBDecoder(layout, tables, early_exit=early_exit, batch_tile=8)
    got, traces = k1_passes(dec, ch, cluster)
    one, one_traces = k1_passes(dec, ch)
    assert traces == one_traces
    if early_exit:
        assert [t.count("vn") for t in traces[:3]] == [2, 3, 5]
    assert _same(got, ib_lut_decode_tiled(layout, dec.trellis("cpu"), ch, 8,
                                          early_exit=early_exit))
    assert _same(got, one)


@pytest.mark.parametrize("cluster, max_iters, early_exit",
                         [(4, 3, True), (3, 3, True), (2, 2, False), (4, 1, True)])
def test_k1_passes_on_clusters_on_wlan_at_its_default_tile(cluster, max_iters, early_exit):
    """WLAN |T| = 16 at its tile of 16 on clusters (the per-lane path, 20
    codewords: a padded last tile), each rank holding only its nodes' rows;
    equal to the twin."""
    layout = get_model("wlan-1296").make_layout()
    tables = DecoderConfig.load(f"{CONFIGS}/wlan_T16_0.8.npz").tables
    dec = FusedIBDecoder(layout, tables, max_iters=max_iters, early_exit=early_exit)
    ch = _clusters(2.4, 16, layout.n_vars, 20, seed=cluster)
    got, _ = k1_passes(dec, ch, cluster)
    assert _same(got, ib_lut_decode_tiled(layout, dec.trellis("cpu"), ch, 16, max_iters,
                                          early_exit))


# -- the schedule's coverage --------------------------------------------------


@pytest.mark.parametrize(
    "model, config, batch_tile",
    [("wlan-1296", "wlan_T16_0.8", 16), ("regular-3-6-8000", "regular_T16_1.05", 4)],
)
@pytest.mark.parametrize("kind", ["cn", "vn", "decide"])
def test_each_pass_covers_every_node_column_and_output_once(model, config, batch_tile, kind):
    """Every (node, column) of a pass is one thread's, once; a node's outputs
    go to every row of its edges, so every (edge, column) of the view the
    pass writes is written once."""
    layout = get_model(model).make_layout()
    w = k1_walk(layout, batch_tile, kind)
    groups = layout.cn_groups if kind == "cn" else layout.vn_groups
    v = k1.columns_per_thread(batch_tile)
    assert v == 4 and k1.threads_per_cta(batch_tile) == 640
    # A thread keeps its columns: c0 is a function of the thread alone.
    lanes = batch_tile // v
    assert np.array_equal(w["c0"], w["thread"] % lanes * v)
    tables = DecoderConfig.load(f"{CONFIGS}/{config}.npz").tables
    arrays = FusedIBDecoder(layout, tables).host_arrays()
    route = arrays["cn_route16" if kind == "cn" else "vn_route16"].astype(np.int64)
    written = np.zeros((layout.n_edges, batch_tile), dtype=np.int64)
    for gi, g in enumerate(groups):
        count = np.zeros((g.num_nodes, batch_tile), dtype=np.int64)
        sel = np.flatnonzero(w["group"] == gi)
        for ln, c0 in zip(w["ln"][sel], w["c0"][sel]):
            count[ln, c0 : c0 + v] += 1
            rows = g.offset + np.arange(g.degree) * g.num_nodes + ln
            written[route[rows], c0 : c0 + v] += 1
        assert np.all(count == 1), (g.degree, np.unique(count))
    if kind != "decide":
        assert np.all(written == 1)
    # Each thread's share of the pass differs from another's by one node.
    per_thread = np.bincount(w["thread"], minlength=k1.threads_per_cta(batch_tile))
    assert per_thread.max() - per_thread.min() <= 1
    # On clusters, the ranks' walks together cover every
    # (node, column) once, and write every (edge, column) once.
    nodes = sum(g.num_nodes for g in groups)
    for cluster in k1.CLUSTER_SIZES:
        split = k1.cluster_split(layout, cluster)[0 if kind == "cn" else 1]
        count = np.zeros((nodes, batch_tile), dtype=np.int64)
        written[:] = 0
        first = np.cumsum([0] + [g.num_nodes for g in groups])
        for r in range(cluster):
            wr = k1_walk(layout, batch_tile, kind, (split[r], split[r + 1]))
            for gi, ln, c0 in zip(wr["group"], wr["ln"], wr["c0"]):
                g = groups[gi]
                count[first[gi] + ln, c0 : c0 + v] += 1
                written[route[g.offset + np.arange(g.degree) * g.num_nodes + ln], c0 : c0 + v] += 1
        assert np.all(count == 1)
        if kind != "decide":
            assert np.all(written == 1)


def test_default_tiles_are_pinned():
    """The exit granularity: WLAN |T|=16 and 32 at 16 codewords a tile,
    regular N=8000 at 4; K1's own carve (routes included where they fit)
    stays inside one CTA's shared memory."""
    wlan = get_model("wlan-1296").make_layout()
    reg = get_model("regular-3-6-8000").make_layout()
    tiles = []
    for layout, config in ((wlan, "wlan_T16_0.8"), (wlan, "wlan_T32_0.6"),
                           (reg, "regular_T16_1.05")):
        t = DecoderConfig.load(f"{CONFIGS}/{config}.npz").tables
        dec = FusedIBDecoder(layout, t)
        tiles.append(dec.batch_tile)
        got = k1.kernel_shared_bytes(layout, dec.batch_tile, t.cardinality_t_channel,
                                     t.cardinality_t_decoder)
        assert got.bytes <= k1.MAX_SHARED_BYTES
    assert tiles == [16, 16, 4]


@pytest.mark.parametrize("batch_tile, columns, threads", [(16, 4, 640), (4, 4, 640), (8, 4, 640),
                                                          (32, 4, 640), (5, 1, 1020), (1, 1, 1024)])
def test_threads_keep_whole_node_rows(batch_tile, columns, threads):
    """A block holds whole node rows of tile / V threads: V = 4 where 4
    divides the tile (640 threads at most), else 1 (1024)."""
    assert k1.columns_per_thread(batch_tile) == columns
    assert k1.threads_per_cta(batch_tile) == threads
    assert threads % (batch_tile // columns) == 0


# -- thread-block clusters -----------------------------------------------------


@pytest.mark.parametrize(
    "tiles, active, cluster",
    [
        (32, {4: 32, 3: 44, 2: 66}, 4),  # the queue's batch 512: 32 tiles of 16
        (32, {4: 30, 3: 44, 2: 66}, 3),  # an H100 SXM holds 30 clusters of 4
        (32, {4: 31, 2: 66}, 2),
        (32, {4: 16, 3: 31, 2: 66}, 2),
        (64, {4: 30, 3: 44, 2: 66}, 2),  # batch 1024
        (66, {4: 33, 3: 44, 2: 66}, 2),
        (67, {4: 33, 3: 44, 2: 66}, 1),
        (128, {4: 30, 3: 44, 2: 66}, 1),  # |T| = 16 at 2048
        (256, {4: 30, 3: 44, 2: 66}, 1),  # the headline's 4096
        (1, {4: 0, 3: 0, 2: 0}, 1),  # no cluster fits beside the carve
    ],
)
def test_cluster_rule_takes_the_largest_cluster_in_one_wave(tiles, active, cluster):
    """K1's cluster rule: the largest of 4, 3 and 2 CTAs a tile at which the
    launch's tiles fit the clusters the card holds at once, else 1."""
    assert k1.cluster_size(tiles, active) == cluster


def test_cluster_rule_never_makes_a_second_wave():
    for tiles in range(1, 300):
        for a4 in (0, 16, 30, 32, 33):
            for a3 in (0, 31, 44):
                for a2 in (0, 33, 64, 66):
                    active = {4: a4, 3: a3, 2: a2}
                    c = k1.cluster_size(tiles, active)
                    assert c in (1, *k1.CLUSTER_SIZES)
                    assert c == 1 or tiles <= active[c]
                    # No larger size fits, and 1 only where none does.
                    assert all(tiles > active[b] for b in k1.CLUSTER_SIZES if b > c)


@pytest.mark.parametrize("cluster", k1.CLUSTER_SIZES)
@pytest.mark.parametrize(
    "model, config",
    [("wlan-1296", "wlan_T16_0.8"), ("wlan-1296", "wlan_T32_0.6"),
     ("regular-3-6-8000", "regular_T16_1.05")],
)
def test_cluster_split_owns_each_node_once_and_routes_to_the_owner(model, config, cluster):
    """Each rank of a cluster walks a contiguous share of the checks and of
    the variables; every node is one rank's; the lookups of two ranks differ
    by at most one node's; and every routed row goes to the rank whose walk
    reads it (the packed rank of ``cluster_arrays``), at the row the
    one-CTA route names."""
    layout = get_model(model).make_layout()
    tables = DecoderConfig.load(f"{CONFIGS}/{config}.npz").tables
    host = FusedIBDecoder(layout, tables).host_arrays()
    arrays = k1.cluster_arrays(layout, cluster)
    split = arrays["split"].reshape(2, cluster + 1)
    assert arrays["cn_route_cl"].dtype == arrays["vn_route_cl"].dtype == np.uint32
    reads = {}
    for k, (kind, groups) in enumerate((("cn", layout.cn_groups), ("vn", layout.vn_groups))):
        n = sum(g.num_nodes for g in groups)
        assert split[k, 0] == 0 and split[k, -1] == n and np.all(np.diff(split[k]) > 0)
        owner = np.repeat(np.arange(cluster), np.diff(split[k]))
        assert len(owner) == n  # every node one rank's
        w = k1.node_lookups(layout, kind)
        loads = [w[split[k, r] : split[k, r + 1]].sum() for r in range(cluster)]
        assert max(loads) - min(loads) <= w.max(), loads
        # The view rows each rank's pass reads: the edges of its nodes.
        rank = np.full(layout.n_edges, -1)
        first = np.cumsum([0] + [g.num_nodes for g in groups])
        for gi, g in enumerate(groups):
            for ln in range(g.num_nodes):
                rows = g.offset + np.arange(g.degree) * g.num_nodes + ln
                assert np.all(rank[rows] == -1)
                rank[rows] = owner[first[gi] + ln]
        assert np.all(rank >= 0)
        reads[kind] = rank
    for kind, to in (("cn", "vn"), ("vn", "cn")):
        packed = arrays[f"{kind}_route_cl"].astype(np.int64)
        row = packed & 0xFFFF
        if layout.n_edges <= 65536:
            assert np.array_equal(row, host[f"{kind}_route16"])
        assert np.array_equal(row, host[f"{kind}_route"])
        assert np.array_equal(packed >> 16, reads[to][row])


# -- the per-lane tables -------------------------------------------------------


@pytest.mark.parametrize("batch_tile", k1.BATCH_TILES)
@pytest.mark.parametrize("config", ["wlan_T16_0.8", "wlan_T32_0.6"])
def test_lane_lookups_equal_the_per_block_lookups(config, batch_tile):
    """Staged in K1's order (CN stage 0, then VN stage k beside CN pass k and
    CN stage k + 1 beside VN pass k), every lane's copy of every slot and
    entry of the pass that reads it equals the per-block table, and a stage
    leaves the bytes the other pass reads as they were. |T| = 32 takes no
    per-lane tables at any tile; |T| = 16 at every tile that 4 divides and
    whose carve fits."""
    layout = get_model("wlan-1296").make_layout()
    t = DecoderConfig.load(f"{CONFIGS}/{config}.npz").tables
    T, Tch = t.cardinality_t_decoder, t.cardinality_t_channel
    dec = FusedIBDecoder(layout, t, batch_tile=batch_tile)
    host = dec.host_arrays()
    lanes = k1.kernel_shared_bytes(layout, batch_tile, Tch, T).lanes
    assert lanes == (T == 16 and batch_tile in (16, 8, 4))
    assert ("lane_cn" in host) == lanes
    if not lanes:
        return
    c, v, slot = host["cn_tab"].shape[1], layout.d_v_max - 1, host["cn_tab"].shape[2]
    mem = torch.zeros(k1.LANE_BYTES, dtype=torch.int64)
    cn_groups, vn_group0 = k1.lane_groups(layout)
    assert (cn_groups, vn_group0) == (2, 1)
    entry = torch.arange(slot)[:, None]
    lane = torch.arange(32)[None, :]

    def read(kind, s):  # [entries, lanes] of one slot
        q = lane_position(kind, s)
        return mem[q // 4 * LANE_GROUP + 128 * entry + 4 * lane + q % 4]

    def held(kind, tab, n):
        return all(torch.equal(read(kind, s), torch.as_tensor(tab[s].astype(np.int64))[:, None]
                               .expand(slot, 32)) for s in range(n))

    for i in range(t.i_max):
        rows = spread_stage(mem, host["lane_cn"][i], 0, cn_groups, layout.d_c_max * T)
        assert held("cn", host["cn_tab"][i], c)
        assert np.array_equal(rows.numpy(), host["match_cn"][i].reshape(-1))
        if i:  # VN pass i - 1 reads its tables beside this stage
            assert held("vn", host["vn_tab"][i - 1], v)
        rows = spread_stage(mem, host["lane_vn"][i], vn_group0, 4 - vn_group0,
                            layout.d_v_max * T)
        assert held("vn", host["vn_tab"][i], v) and held("cn", host["cn_tab"][i], c)
        assert np.array_equal(rows.numpy(), host["match_vn"][i].reshape(-1))


def _cu_constants() -> dict[str, int]:
    import re
    from pathlib import Path

    src = (Path(k1.__file__).parents[1] / "csrc" / "ib_lut_fused.cu").read_text()
    return {m[1]: int(m[2]) for m in re.finditer(r"constexpr (?:int|size_t) (k\w+) = (\d+);", src)}


@pytest.mark.parametrize(
    "model, config, tile, carve",
    [
        ("wlan-1296", "wlan_T16_0.8", 16, (222_672, False, True)),
        ("wlan-1296", "wlan_T32_0.6", 16, (206_064, True, False)),
        ("regular-3-6-8000", "regular_T16_1.05", 4, (225_968, False, False)),
    ],
)
def test_carve_and_tile_rule_match_the_kernel(model, config, tile, carve):
    """The tile rule and K1's carve on the three layouts K1 runs: the bytes
    and paths the header of csrc/ib_lut_fused.cu states (WLAN |T| = 16 on
    per-lane tables, |T| = 32 with the routes in shared memory, regular
    N = 8000 reading them from device memory), with the wrapper's constants
    equal to the source's."""
    consts = _cu_constants()
    assert consts["kMaxShared"] == k1.MAX_SHARED_BYTES
    assert consts["kLanePositions"] == k1.LANE_POSITIONS
    assert consts["kLaneEntries"] == k1.LANE_ENTRIES and consts["kLaneMaxT"] == k1.LANE_MAX_T
    assert k1.LANE_BYTES == 131_072
    assert consts["kMaxCluster"] == max(k1.CLUSTER_SIZES)
    layout = get_model(model).make_layout()
    t = DecoderConfig.load(f"{CONFIGS}/{config}.npz").tables
    T, Tch = t.cardinality_t_decoder, t.cardinality_t_channel
    assert k1.pick_batch_tile(layout, Tch, T) == tile
    assert k1.kernel_shared_bytes(layout, tile, Tch, T) == carve
    # The tile rule reads byte views and one table copy: the next tile up
    # does not fit them, whichever path the tile then takes.
    if tile < k1.BATCH_TILES[0]:
        assert k1.shared_bytes(layout, 2 * tile, Tch, T) > k1.MAX_SHARED_BYTES
