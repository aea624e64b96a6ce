"""The benchmark matrix of the PyTorch port and the paths it opens.

- K5's plain chains against the JAX package's primitives on the same numpy
  tables and states: the 2-D chain against ``pairwise_lookup`` in packed
  mode, the 1-D chain against ``vector_lookup_words``, the float pair chains
  against the JAX float ops (exact; box-plus within ``BP_RTOL``);
- the roofline's lookup counts against the JAX matrix script's traced
  primitive counts (``scripts/bench_matrix.py``, loaded unedited), and
  against the port's own plain fold with counting tables;
- ``backend='xla'`` (the whole-batch decoders) and the regular N=8000 code
  through the engine, against the JAX simulator's step;
- the matrix's cells, its CPU refusal, and the roofline arithmetic.
"""

import dataclasses
import importlib.util
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from informationbottleneckdecodingldpc_tpu.channel.quantizer import (
    sample_clusters_from_uniform as jax_sample_clusters,
    sample_llrs_from_uniform as jax_sample_llrs,
)
from informationbottleneckdecodingldpc_tpu.codes import TannerGraph as JaxGraph
from informationbottleneckdecodingldpc_tpu.codes.random_codes import regular_qc_parity_check
from informationbottleneckdecodingldpc_tpu.construct import DecoderConfig as JaxConfig
from informationbottleneckdecodingldpc_tpu.decode import DecodeLayout as JaxLayout
from informationbottleneckdecodingldpc_tpu.decode import DeviceTrellis as JaxTrellis
from informationbottleneckdecodingldpc_tpu.models import get_model as jax_model
from informationbottleneckdecodingldpc_tpu.ops import float_ops as jax_float
from informationbottleneckdecodingldpc_tpu.ops import lut_fold as jax_fold
from informationbottleneckdecodingldpc_tpu.sim import BERSimulator as JaxSimulator
from informationbottleneckdecodingldpc_torch.cli import bench_matrix
from informationbottleneckdecodingldpc_torch.codes import TannerGraph
from informationbottleneckdecodingldpc_torch.construct import DecoderConfig, TrellisTables
from informationbottleneckdecodingldpc_torch.decode import DecodeLayout, DeviceTrellis, ib_lut_decode
from informationbottleneckdecodingldpc_torch.kernels import hbm_copy
from informationbottleneckdecodingldpc_torch.kernels import peaks as k5
from informationbottleneckdecodingldpc_torch.kernels.ib_lut_fused import pick_batch_tile
from informationbottleneckdecodingldpc_torch.models import get_model
from informationbottleneckdecodingldpc_torch.sim import BERSimulator
from informationbottleneckdecodingldpc_torch.sim.engine import WholeBatchDecoder, fused_fits
from informationbottleneckdecodingldpc_torch.sim.rng import consume
from informationbottleneckdecodingldpc_torch.utils import MATRIX, peaks, roofline

REPO = Path(__file__).resolve().parents[1]
CONFIGS = REPO / "results" / "configs"
BP_RTOL = 1e-5  # as in tests/test_torch_float.py


@pytest.fixture(scope="module")
def jax_matrix():
    """The JAX package's matrix script, loaded unedited."""
    spec = importlib.util.spec_from_file_location("jax_bench_matrix", REPO / "scripts" / "bench_matrix.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _tables(name):
    return DecoderConfig.load(str(CONFIGS / f"{name}.npz")).tables


def _jax_tables(name):
    return JaxConfig.load(str(CONFIGS / f"{name}.npz")).tables


# -- K5: the plain chains against the JAX primitives --------------------------

@pytest.mark.parametrize("t", [16, 32])
def test_lookup2d_chain_matches_jax_packed_lookup(t):
    table, init = k5.chain_inputs("lookup2d", 8, t, seed=t)
    got = k5.lookup_chain("lookup2d", torch.as_tensor(table), torch.as_tensor(init), loops=1)
    prev = jax_fold._FORCE_MODE
    jax_fold.set_lookup_mode("packed")
    try:
        luts = [jnp.asarray(table[l].astype(np.int32)) for l in range(k5.SLOTS)]
        a, b = jnp.asarray(init[: k5.CHAINS]), jnp.asarray(init[k5.CHAINS :])
        for k in range(0, k5.STEPS, 2):
            a = jax_fold.pairwise_lookup(luts[k % k5.SLOTS], a, b, vmax=t)
            b = jax_fold.pairwise_lookup(luts[(k + 1) % k5.SLOTS], b, a, vmax=t)
    finally:
        jax_fold.set_lookup_mode(prev)
    want = np.asarray(a).sum(0) + np.asarray(b).sum(0)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("t", [16, 32])
def test_lookup2d_lanes_chain_equals_the_shared_table_chain(t):
    # The per-lane copies change where a table lies, not what a lookup gives.
    table, init = k5.chain_inputs("lookup2d_lanes", 16, t, seed=t)
    assert np.array_equal(table, k5.chain_inputs("lookup2d", 16, t, seed=t)[0])
    table, init = torch.as_tensor(table), torch.as_tensor(init)
    got = k5.lookup_chain("lookup2d_lanes", table, init, loops=1)
    assert torch.equal(got, k5.lookup_chain("lookup2d", table, init, loops=1))
    assert k5.launches["lookup2d_lanes_T16"] == k5.launches["lookup2d_lanes_T32"] == 0
    # The faster layout is the pairwise-lookup peak.
    fake = {("lookup2d", t): 3.0e12, ("lookup2d_lanes", t): 7.0e12}
    assert peaks.lookup2d_peak(t, lambda *k: fake[k]) == 7.0e12


@pytest.mark.parametrize("t", [16, 32])
def test_lookup1d_chain_matches_jax_vector_lookup_words(t):
    table, init = k5.chain_inputs("lookup1d", 8, t, seed=t)
    got = k5.lookup_chain("lookup1d", torch.as_tensor(table), torch.as_tensor(init), loops=2)
    fb = jax_fold._field_bits(t)
    words = jnp.asarray(jax_fold.pack_lut_batch(table.astype(np.int32)[:, None], t)[:, 0])
    s = jnp.asarray(init)
    for _ in range(2 * k5.STEPS):
        s = jax_fold.vector_lookup_words(words, s, fb)
    assert np.array_equal(got.numpy(), np.asarray(s).sum(0))


JAX_FLOAT_OPS = {
    "minsum_op": jax_float.min_sum_op,
    "boxplus": jax_float.boxplus,
    "float_mix": lambda a, b: jnp.clip(a + b, -150.0, 150.0),
    "min": jnp.minimum,
}


@pytest.mark.parametrize("op", list(k5.FLOAT_OPS))
def test_float_pair_chain_matches_jax_ops(op):
    _, init = k5.chain_inputs(op, 64, seed=7)
    x, y = k5.float_pair_states(op, torch.as_tensor(init[: k5.CHAINS]), torch.as_tensor(init[k5.CHAINS :]), 4)
    jx, jy = jnp.asarray(init[: k5.CHAINS]), jnp.asarray(init[k5.CHAINS :])
    for _ in range(4):  # 8 applications
        jx = JAX_FLOAT_OPS[op](jx, jy)
        jy = JAX_FLOAT_OPS[op](jy, -jx)
    for got, want in ((x, jx), (y, jy)):
        want = np.asarray(want)
        if op == "boxplus":
            assert np.all(np.abs(got.numpy() - want) <= BP_RTOL * np.maximum(1.0, np.abs(want)))
        else:
            assert np.all(got.numpy() == want)  # +0 == -0


def test_float_chain_sums_the_pair_states_in_chain_order():
    _, init = k5.chain_inputs("boxplus", 16, seed=1)
    init = torch.as_tensor(init)
    got = k5.float_chain("boxplus", init, loops=1)
    x, _ = k5.float_pair_states("boxplus", init[: k5.CHAINS], init[k5.CHAINS :], k5.STEPS // 2)
    acc = x[0]
    for c in range(1, k5.CHAINS):
        acc = acc + x[c]
    assert torch.equal(got, acc) and k5.launches["boxplus"] == 0


def test_copy_plain_and_wrappers_refuse_what_the_kernels_do_not_take():
    src = torch.arange(64, dtype=torch.int32)
    dst = torch.zeros_like(src)
    hbm_copy.copy(src, dst, passes=2)
    assert torch.equal(src, dst) and hbm_copy.launches["hbm_copy"] == 0
    meta = torch.zeros(5, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="16-byte"):  # any size, but aligned
        hbm_copy.copy(meta[1:], torch.zeros_like(meta)[1:])
    with pytest.raises(ValueError, match="multiple of 256"):
        k5.float_chain("min", torch.zeros((2 * k5.CHAINS, 100), device="meta"), 1)
    table = torch.zeros((k5.SLOTS, 32, 32), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="multiple of 1024"):
        k5.lookup_chain("lookup2d_lanes", table, torch.zeros((2 * k5.CHAINS, 512), dtype=torch.int32, device="meta"), 1)
    with pytest.raises(ValueError, match="unknown"):
        k5.lookup_chain("lookup3d", None, torch.zeros(1), 1)


def test_peak_measurements_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        peaks.primitive_peak("lookup2d", 16)
    with pytest.raises(RuntimeError, match="CUDA"):
        roofline.measure_hbm_bandwidth()
    with pytest.raises(RuntimeError, match="CUDA"):
        roofline.traffic_bandwidth()
    with pytest.raises(RuntimeError, match="CUDA"):
        peaks.measure_float_binop_peak("min", device="cpu")


# -- counts ----------------------------------------------------------------------

@pytest.mark.parametrize(
    "model, config, expected",
    [
        ("wlan-1296", "wlan_T16_0.8", 40986),
        ("wlan-1296-T32", "wlan_T32_0.6", 40986),
        ("regular-3-6-8000", "regular_T16_1.05", 112000),
        ("dvbs2-64800", "dvbs2_T16_0.6", None),
    ],
)
def test_lookup_counts_equal_the_jax_traced_extracts(jax_matrix, model, config, expected):
    counts = roofline.ib_lookup_counts(get_model(model).make_layout(), _tables(config))
    jax_counts = jax_matrix.ib_primitive_counts(
        jax_model(model).make_layout(), JaxTrellis.from_tables(_jax_tables(config))
    )
    ext = sum(n for k, n in jax_counts.items() if k[0] == "ext")
    assert sum(counts.values()) == ext
    if expected is not None:
        assert ext == expected
    t = _tables(config).cardinality_t_decoder
    assert set(counts) <= {("lookup2d", t), ("lookup1d", t)}
    if model == "wlan-1296":
        assert counts == {("lookup2d", 16): 31698, ("lookup1d", 16): 9288}
    if model == "regular-3-6-8000":
        assert counts == {("lookup2d", 16): 112000}


class _CountingTable:
    """A table whose lookups are counted: a tuple of index tensors is a
    pairwise lookup, one index tensor a 1-D lookup, an int a slice."""

    def __init__(self, table, counts):
        self.table, self.counts = table, counts

    def __getitem__(self, key):
        if isinstance(key, tuple):
            self.counts["2d"] += key[0].numel()
            return self.table[key]
        if torch.is_tensor(key):
            self.counts["1d"] += key.numel()
            return self.table[key]
        return _CountingTable(self.table[key], self.counts)


def _random_tables(t=16, i_max=3, d_c=6, d_v=3, seed=0):
    rng = np.random.default_rng(seed)
    r = lambda *shape: rng.integers(0, t, shape)
    return TrellisTables(
        cardinality_t_channel=t, cardinality_t_decoder=t, i_max=i_max, d_c_max=d_c, d_v_max=d_v,
        cn_iter0_first=r(t, t), cn_iter0_rest=r(d_c - 3, t, t), cn_rest=r(i_max - 1, d_c - 2, t, t),
        vn_first=r(i_max, t, t), vn_rest=r(i_max, d_v - 1, t, t),
        matching_cn=r(i_max, d_c, t), matching_vn=r(i_max, d_v, t),
    )


@pytest.mark.parametrize("use_matching", [True, False])
def test_lookup_counts_equal_the_plain_fold_instrumented(use_matching):
    layout = DecodeLayout.from_graph(TannerGraph.from_check_matrix(regular_qc_parity_check(96, 3, 6, seed=7)))
    tables = _random_tables()
    trellis = DeviceTrellis.from_tables(tables, "cpu", use_matching=use_matching)
    ch = torch.as_tensor(np.random.default_rng(1).integers(0, 16, (96, 1)).astype(np.int32))

    def counted(max_iters):
        counts = {"2d": 0, "1d": 0}
        fields = ("cn_iter0_first", "cn_iter0_rest", "cn_rest", "vn_first", "vn_rest", "matching_cn", "matching_vn")
        wrapped = dataclasses.replace(trellis, **{
            f: _CountingTable(getattr(trellis, f), counts) for f in fields if getattr(trellis, f) is not None
        })
        ib_lut_decode(layout, wrapped, ch, max_iters=max_iters, early_exit=False)
        return counts

    one, two = counted(1), counted(2)
    want = roofline.ib_lookup_counts(layout, tables, use_matching)
    assert two["2d"] - one["2d"] == want[("lookup2d", 16)] == 48 * 18 + 96 * 5
    assert two["1d"] - one["1d"] == want.get(("lookup1d", 16), 0) == (2 * 288 if use_matching else 0)


def test_float_cn_applications_equal_jax(jax_matrix):
    for model in ("wlan-1296", "regular-3-6-8000"):
        got = roofline.float_cn_applications(get_model(model).make_layout())
        assert got == jax_matrix.float_cn_applications(jax_model(model).make_layout())
    assert roofline.float_cn_applications(get_model("wlan-1296").make_layout()) == 10044


# -- the roofline arithmetic -------------------------------------------------------

FAKE_PEAKS = {
    ("lookup2d", 16): 3.0e12, ("lookup2d_lanes", 16): 2.0e12, ("lookup1d", 16): 5.0e12,
    ("minsum_op",): 2.0e12, ("boxplus",): 4.0e11,
}


def _fake_peak(*key):
    return FAKE_PEAKS[key]


def test_roofline_arithmetic_follows_the_jax_formulas():
    wlan = get_model("wlan-1296").make_layout()
    tables = _tables("wlan_T16_0.8")
    ib = roofline.cell_roofline(wlan, "ib", "fused", 49.0, _fake_peak, None, tables=tables,
                                achieved_bps=1.5e9)
    t_iter = 31698 / 3.0e12 + 9288 / 5.0e12
    assert ib["speed_of_light_coded_mbps"] == pytest.approx(1296 / (t_iter * 49.0) / 1e6, rel=1e-12)
    assert ib["fraction_of_sol"] == pytest.approx(1.5e9 / (1296 / (t_iter * 49.0)), rel=1e-12)
    bp = roofline.cell_roofline(wlan, "bp", "fused", 27.37, _fake_peak, None)
    assert bp["speed_of_light_coded_mbps"] * 1e6 == pytest.approx(1296 * 4.0e11 / (10044 * 27.37), rel=1e-12)
    ms = roofline.cell_roofline(wlan, "minsum", "fused", 48.75, _fake_peak, None)
    assert ms["speed_of_light_coded_mbps"] * 1e6 == pytest.approx(1296 * 7 * 2.0e12 / (4 * 4644 * 48.75), rel=1e-12)
    assert ms["bound"] == "cn_minsum_alu_floor" and "hbm_traffic_sol_coded_mbps" not in ms
    # i_eff below one counts as one iteration.
    assert roofline.cell_roofline(wlan, "bp", "fused", 0.0, _fake_peak, None)["i_eff"] == 1.0


def test_traffic_bound_applies_to_hbm_cells_with_the_kernels_view_bytes():
    dv = get_model("dvbs2-64800").make_layout()
    bw = 2.5e12
    k4 = roofline.cell_roofline(dv, "minsum", "hbm", 49.0, _fake_peak, bw, achieved_bps=7e8)
    # Min-sum on K4's node-state path: 10-byte check records read twice and
    # written once, the totals written and read, the channel LLRs read.
    assert k4["view_bytes_per_body_per_codeword"] == 30 * 32400 + 12 * 64800
    want = bw * 64800 / ((30 * 32400 + 12 * 64800) * 49.0)
    assert k4["bound"] == "hbm_traffic"
    assert k4["speed_of_light_coded_mbps"] * 1e6 == pytest.approx(want, rel=1e-12)
    # BP keeps K4's four float32 views an edge.
    assert roofline.view_bytes_per_body(dv, "bp") == 16 * 226799
    k3 = roofline.cell_roofline(dv, "ib", "hbm", 49.0, _fake_peak, bw, tables=_tables("dvbs2_T16_0.6"))
    # |T| = 16: K3's views hold two 4-bit messages a byte.
    assert k3["view_bytes_per_body_per_codeword"] == (4 * 226799 + 64800) / 2
    assert k3["hbm_traffic_sol_coded_mbps"] * 1e6 == pytest.approx(bw * 64800 / ((4 * 226799 + 64800) / 2 * 49.0), rel=1e-12)
    assert k3["speed_of_light_coded_mbps"] <= k3["hbm_traffic_sol_coded_mbps"]
    # |T| = 32 stays on bytes.
    wlan = get_model("wlan-1296").make_layout()
    assert roofline.view_bytes_per_body(wlan, "ib", _tables("wlan_T32_0.6")) == 4 * 4644 + 1296
    assert roofline.view_bytes_per_body(wlan, "ib", _tables("wlan_T16_0.8")) == (4 * 4644 + 1296) / 2


def test_decode_bound_counts_one_read_one_write_and_the_lookups():
    wlan = get_model("wlan-1296").make_layout()
    tables = _tables("wlan_T16_0.8")
    b = roofline.decode_bound(wlan, "ib", 4096, 49.0, tables)
    cn0 = 648 * 0 + sum(g.num_nodes * ((g.degree - 2) * (g.degree + 3) // 2 + g.degree) for g in wlan.cn_groups)
    lookups = 4096 * (cn0 + 49.0 * 40986 + 4644)
    assert b["ops"] == {"lookup": lookups}
    # One shared-memory load per lookup: 32 per SM and clock, 132 SMs at 1.98 GHz.
    assert b["compute_ms"] == pytest.approx(lookups / (132 * 32 * 1.98e9) * 1e3, rel=1e-12)
    assert b["bytes"] >= 4096 * 8 * 1296
    assert b["bound_ms"] == max(b["io_ms"], b["compute_ms"]) and b["bound_by"] == "operations"
    # Min-sum: a check edge's abs, min tracking, select and sign at the
    # compare rate (64 per SM and clock); a variable edge's add and subtract
    # at 128 and its clip's minimum and maximum at 64; the decision's sums.
    f = roofline.decode_bound(wlan, "minsum", 4096, 49.0)
    assert f["ops"] == {"fp32": 4096 * (49.0 * 2 * 4644 + 4644), "compare": 4096 * 49.0 * 6 * 4644}
    assert f["busiest"] == "compare"
    assert f["compute_ms"] == pytest.approx(f["ops"]["compare"] / (132 * 64 * 1.98e9) * 1e3, rel=1e-12)
    # BP: each box-plus as its SASS, 78.6 instructions of which 48 add,
    # multiply or FMA: the issue limit bounds it.
    bp = roofline.decode_bound(wlan, "bp", 4096, 49.0)
    assert bp["ops"]["sfu"] == 4096 * 49.0 * 2 * 10044
    issue = 4096 * (49.0 * (roofline.BOXPLUS_SASS["issue"] * 10044 + 4 * 4644) + 4644)
    assert bp["ops"]["issue"] == pytest.approx(issue, rel=1e-12) and bp["busiest"] == "issue"
    assert bp["compute_ms"] == pytest.approx(issue / (132 * 128 * 1.98e9) * 1e3, rel=1e-12)
    assert roofline.bound(0, {"sfu": 132 * 16 * 1.98e9})["compute_ms"] == pytest.approx(1e3)


@pytest.mark.parametrize("klass, per_clock", [
    ("fp32", 128), ("compare", 64), ("sfu", 16), ("conversion", 16), ("int32", 64), ("logic", 64),
    ("lookup", 32), ("issue", 128)])
def test_pipe_classes_follow_the_guide_for_compute_capability_9(klass, per_clock):
    """One second of one class's work on 132 SMs at 1.98 GHz, at the CUDA
    C++ Programming Guide's rate per SM and clock for compute capability
    9.0; alone in a loop, a class is also held to the issue limit, which
    only the classes at 128 a clock reach."""
    n = 132 * per_clock * 1.98e9
    b = roofline.bound(0, {klass: n})
    assert b["compute_ms"] == pytest.approx(1e3, rel=1e-12) and b["busiest"] == klass
    assert roofline.DATA_SHEET_OPS_PER_S[klass] == pytest.approx(n, rel=1e-12)


def test_issue_limit_bounds_a_loop_whose_instructions_outnumber_any_pipe():
    """Each sub-partition issues one warp instruction a clock, 128 thread
    instructions per SM whatever the pipe: 100 adds and 40 compares take
    longer than either pipe alone needs, and a SASS count of a loop's every
    instruction can add what no class counts."""
    rate = 132 * 1.98e9
    b = roofline.bound(0, {"fp32": 100 * rate, "compare": 40 * rate})
    assert b["busiest"] == "issue" and b["compute_ms"] == pytest.approx(140 / 128 * 1e3, rel=1e-12)
    assert b["compute_ms"] > max(100 / 128, 40 / 64) * 1e3
    b = roofline.bound(0, {"fp32": 100 * rate, "issue": 160 * rate})
    assert b["busiest"] == "issue" and b["compute_ms"] == pytest.approx(160 / 128 * 1e3, rel=1e-12)
    # The tensor cores' flops are no instructions; bytes alone bound a copy.
    assert roofline.bound(0, {"tensor_f16": 989e12})["busiest"] == "tensor_f16"
    assert roofline.bound(3.35e9, {}) == {"io_ms": pytest.approx(1.0), "compute_ms": 0.0,
                                          "busiest": None, "bound_ms": pytest.approx(1.0),
                                          "bound_by": "bytes"}


def test_float_op_counts_by_class_from_their_sass():
    """K5c's four ops by class: box-plus's 78.6 instructions an application
    (48 add, multiply or FMA) put it under the issue limit; the min-sum op's
    6.05 compares and selects, add+clip's 2 and min's 1 under the compare
    rate."""
    counts = roofline.FLOAT_OP_COUNTS
    assert counts["boxplus"] == {"fp32": 48.0, "compare": 6.125, "sfu": 2.0, "conversion": 2.0,
                                 "issue": pytest.approx(78.637, abs=1e-3)}
    busiest = {op: roofline.bound(0, c)["busiest"] for op, c in counts.items()}
    assert busiest == {"minsum_op": "compare", "boxplus": "issue", "float_mix": "compare",
                       "min": "compare"}
    assert counts["min"]["compare"] == 1 and counts["float_mix"]["compare"] == 2
    assert roofline.BOXPLUS_SASS is counts["boxplus"]


# -- backend='xla' and the regular N=8000 code through the engine -------------------

def test_xla_backend_ib_step_matches_jax_xla_step():
    layout = get_model("wlan-1296").make_layout()
    tables, batch = _tables("wlan_T16_0.8"), 8
    sim = BERSimulator(
        layout, "ib", device="cpu", trellis=DeviceTrellis.from_tables(tables, "cpu"),
        max_iters=5, batch_per_device=batch, backend="xla",
    )
    assert sim.backend == "xla" and isinstance(sim.fused_decoder, WholeBatchDecoder)
    jsim = JaxSimulator(
        jax_model("wlan-1296").make_layout(), "ib", trellis=JaxTrellis.from_tables(_jax_tables("wlan_T16_0.8")),
        max_iters=5, batch_per_device=batch, n_devices=1, backend="xla",
    )
    u = np.random.default_rng(2).random((layout.n_vars, batch), dtype=np.float32)
    qt, jqt = sim.quantizer_for(1.0), jsim.quantizer_for(1.0)
    errors, frames, iters = sim.decode_and_count(
        consume(sim.channel_input_kind, torch.as_tensor(u), qt))
    zeros = jnp.zeros(u.shape, jnp.int32)
    res = jsim._decode(jax_sample_clusters(jqt.cdf, jnp.asarray(u), zeros), None)
    per_cw = jsim._count_errors(res.outputs, zeros)
    assert int(errors) == int(jnp.sum(per_cw)) > 0
    assert int(frames) == int(jnp.sum(per_cw > 0))
    assert float(iters) == float(res.iterations)
    assert sim.fused_decoder.calls == 1


def test_xla_backend_minsum_step_matches_jax_on_qc96():
    H = regular_qc_parity_check(96, 3, 6, seed=7)
    layout = DecodeLayout.from_graph(TannerGraph.from_check_matrix(H))
    jlayout = JaxLayout.from_graph(JaxGraph.from_check_matrix(H))
    batch = 16
    sim = BERSimulator(layout, "minsum", device="cpu", max_iters=20, batch_per_device=batch, backend="xla",
                       cardinality_y_channel=400)
    jsim = JaxSimulator(jlayout, "minsum", max_iters=20, batch_per_device=batch, n_devices=1, backend="xla",
                        cardinality_y_channel=400)
    u = np.random.default_rng(3).random((96, batch), dtype=np.float32)
    qt, jqt = sim.quantizer_for(6.0), jsim.quantizer_for(6.0)
    errors, frames, iters = sim.decode_and_count(
        consume(sim.channel_input_kind, torch.as_tensor(u), qt))
    zeros = jnp.zeros(u.shape, jnp.int32)
    res = jsim._decode(jax_sample_llrs(jqt.cdf, jqt.llrs, jnp.asarray(u), zeros), None)
    per_cw = jsim._count_errors(res.outputs, zeros)
    assert int(errors) == int(jnp.sum(per_cw))
    assert int(frames) == int(jnp.sum(per_cw > 0))
    assert float(iters) == float(res.iterations) < 19  # the whole batch exited early


def test_regular8000_step_matches_jax():
    layout = get_model("regular-3-6-8000").make_layout()
    tables, batch = _tables("regular_T16_1.05"), 2
    assert not tables.has_matching and pick_batch_tile(layout, 16, 16) == 4
    assert fused_fits(layout, tables) and fused_fits(layout, None)
    sim = BERSimulator(
        layout, "ib", device="cpu", trellis=DeviceTrellis.from_tables(tables, "cpu"), max_iters=2,
        count_all_bits=True, batch_per_device=batch, backend="fused",
    )
    assert sim.fused_decoder.batch_tile == 4 and sim.prefix_len == 8000
    jsim = JaxSimulator(
        jax_model("regular-3-6-8000").make_layout(), "ib",
        trellis=JaxTrellis.from_tables(_jax_tables("regular_T16_1.05")), max_iters=2,
        count_all_bits=True, batch_per_device=batch, n_devices=1, backend="xla",
    )
    u = np.random.default_rng(4).random((8000, batch), dtype=np.float32)
    qt, jqt = sim.quantizer_for(1.2), jsim.quantizer_for(1.2)
    errors, frames, iters = sim.decode_and_count(
        consume(sim.channel_input_kind, torch.as_tensor(u), qt))
    zeros = jnp.zeros(u.shape, jnp.int32)
    res = jsim._decode(jax_sample_clusters(jqt.cdf, jnp.asarray(u), zeros), None)
    per_cw = jsim._count_errors(res.outputs, zeros)
    assert int(errors) == int(jnp.sum(per_cw)) > 0
    assert int(frames) == int(jnp.sum(per_cw > 0))
    assert float(iters) == float(res.iterations) == 1.0


# -- the matrix ---------------------------------------------------------------

def test_matrix_cells_are_the_jax_matrix_cells():
    recorded = json.loads((REPO / "results" / "BENCH_MATRIX.json").read_text())["scenarios"]
    assert list(MATRIX) == list(recorded)
    for name, sc in MATRIX.items():
        ref = recorded[name]
        assert (sc["model"], sc["decoder"], sc.get("chain", "allzero")) == (ref["model"], ref["decoder"], ref["chain"])
        if sc["decoder"] == "ib":
            assert sc["backend"] == ref["backend"]
        assert sc.get("ebn0", get_model(sc["model"]).design_ebn0_db) == ref["ebn0_db"]
        want_batch = 1024 if sc["model"] == "dvbs2-64800" else ref["batch"]
        assert sc.get("batch", 512) == want_batch


def test_bench_matrix_refuses_the_cpu(tmp_path):
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_matrix.main(["--device", "cpu", "--out", str(tmp_path / "m.json")])
    assert not (tmp_path / "m.json").exists()
