"""The PyTorch port's device-memory decoders (the plain twins of the CUDA
kernels K3 and K4), the DVB-S2 layout and the engine's backend choice,
against the JAX package.

Inputs are made with numpy from a seed and fed to both sides. The JAX
device-memory Pallas kernels run in interpret mode on the small codes of
tests/test_hbm_kernel.py and tests/test_float_hbm.py: the 1920-variable
DVB-S2-like IRA code with its structured node and edge order, and the
96-variable QC code. IB and min-sum compare with ``==`` (min-sum's +0 == -0),
BP within ``BP_RTOL`` of tests/test_torch_float.py. No DVB-S2 N=64800 decode
runs on the CPU: its layout is compared as host arrays, and the engine's
backend choice by construction.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from informationbottleneckdecodingldpc_tpu.codes import (
    TannerGraph,
    dvbs2_layout_edge_keys,
    dvbs2_layout_node_keys,
    dvbs2_like_parity_check,
)
from informationbottleneckdecodingldpc_tpu.codes.random_codes import (
    regular_qc_parity_check,
)
from informationbottleneckdecodingldpc_tpu.construct import build_decoder_config
from informationbottleneckdecodingldpc_tpu.decode import (
    DecodeLayout as JaxLayout,
    DeviceTrellis as JaxTrellis,
    min_sum_decode as jax_min_sum_decode,
)
from informationbottleneckdecodingldpc_tpu.kernels import (
    HBMFusedIBDecoder as JaxHBMFusedIBDecoder,
)
from informationbottleneckdecodingldpc_tpu.kernels.float_hbm import (
    HBMFloatDecoder as JaxHBMFloatDecoder,
)
from informationbottleneckdecodingldpc_tpu.encode import LDPCEncoder as JaxEncoder
from informationbottleneckdecodingldpc_tpu.models import get_model as jax_model
from informationbottleneckdecodingldpc_tpu.sim import BERSimulator as JaxSimulator
from informationbottleneckdecodingldpc_torch.construct import (
    DecoderConfig,
    TrellisTables,
)
from informationbottleneckdecodingldpc_torch.decode import DecodeLayout, DeviceTrellis
from informationbottleneckdecodingldpc_torch.encode import LDPCEncoder
from informationbottleneckdecodingldpc_torch.kernels import (
    FusedFloatDecoder,
    FusedIBDecoder,
    HBMFloatDecoder,
    HBMFusedIBDecoder,
    pick_batch_tile,
    pick_float_batch_tile,
)
from informationbottleneckdecodingldpc_torch.kernels.ib_lut_hbm import (
    check_view_tile,
    tile_scratch,
    view_bits,
)
from informationbottleneckdecodingldpc_torch.models import get_model
from informationbottleneckdecodingldpc_torch.sim import BERSimulator
from informationbottleneckdecodingldpc_torch.sim.engine import WholeBatchDecoder, fused_fits
from informationbottleneckdecodingldpc_torch.sim.rng import from_received

BP_RTOL = 1e-5  # as in tests/test_torch_float.py
CONFIGS = "results/configs"


@pytest.fixture(scope="module")
def dvbs2():
    return get_model("dvbs2-64800").make_layout(), jax_model("dvbs2-64800").make_layout()


@pytest.fixture(scope="module")
def ira():
    """The DVB-S2-like IRA code of tests/test_hbm_kernel.py with its node and
    edge keys, and an i_max 5 decoder config with message alignment."""
    H = dvbs2_like_parity_check(1920, 960, seed=9)
    g = TannerGraph.from_check_matrix(H)
    ck, vk = dvbs2_layout_node_keys(1920, 960)
    ek_csr, ek_csc = dvbs2_layout_edge_keys(H, 960)
    keys = dict(cn_node_key=ck, vn_node_key=vk, cn_edge_key=ek_csr, vn_edge_key=ek_csc)
    cfg = build_decoder_config(
        design_ebn0_db=1.5,
        cardinality_y_channel=400,
        cardinality_t_channel=16,
        cardinality_t_decoder=16,
        i_max=5,
        H=H,
    )
    return dict(
        H=H,
        layout=DecodeLayout.from_graph(g, **keys),
        jlayout=JaxLayout.from_graph(g, **keys),
        tables=TrellisTables(**dataclasses.asdict(cfg.tables)),
        jtables=cfg.tables,
    )


@pytest.fixture(scope="module")
def qc96():
    g = TannerGraph.from_check_matrix(regular_qc_parity_check(96, 3, 6, seed=7))
    cfg = build_decoder_config(
        design_ebn0_db=2.0,
        cardinality_y_channel=400,
        cardinality_t_channel=16,
        cardinality_t_decoder=16,
        i_max=4,
        d_v=3,
        d_c=6,
    )
    return dict(
        layout=DecodeLayout.from_graph(g),
        jlayout=JaxLayout.from_graph(g),
        tables=TrellisTables(**dataclasses.asdict(cfg.tables)),
        jtables=cfg.tables,
    )


def _clusters(reliable, shape, seed):
    """Uniformly random clusters, or (``reliable``) clusters of the all-zeros
    codeword from the five most reliable ones with 0.5% set to a wrong hard
    decision: the i_max 5 IRA decoder then converges after two bodies."""
    rng = np.random.default_rng(seed)
    if not reliable:
        return torch.as_tensor(rng.integers(0, 16, shape).astype(np.int32))
    ch = rng.integers(11, 16, shape).astype(np.int32)
    ch[rng.random(shape) < 0.005] = 5
    return torch.as_tensor(ch)


def _llrs(seed, shape, mean=1.0, std=1.6):
    return torch.as_tensor(np.random.default_rng(seed).normal(mean, std, shape).astype(np.float32))


def _equal(got: torch.Tensor, want) -> bool:
    """Equal as values: +0 == -0 for floats."""
    want = np.asarray(want)
    return got.shape == want.shape and bool(np.all(got.numpy() == want))


def _close_bp(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    err = np.abs(got.numpy() - want)
    assert np.all(err <= BP_RTOL * np.maximum(1.0, np.abs(want))), err.max()


# -- the DVB-S2 layout --------------------------------------------------------

def test_dvbs2_layout_equals_jax(dvbs2):
    port, ref = dvbs2
    pairs = [
        (port.to_vn_perm, ref.to_vn.perm),
        (port.to_cn_perm, ref.to_cn.perm),
        (port.cn_edge_var, ref.seed_plan.perm),
        (port.vn_node_order, ref.vn_gather_plan.perm),
    ]
    for got, want in pairs:
        assert got.dtype == np.int32
        assert np.array_equal(got, np.asarray(want))
    assert (port.n_vars, port.n_checks, port.n_edges) == (64800, 32400, 226799)
    assert [(g.degree, g.num_nodes) for g in port.cn_groups] == [(6, 1), (7, 32399)]
    assert [(g.degree, g.num_nodes) for g in port.vn_groups] == [
        (1, 1), (2, 32399), (3, 19440), (8, 12960),
    ]
    for mine, theirs in ((port.cn_groups, ref.cn_groups), (port.vn_groups, ref.vn_groups)):
        assert [(g.degree, g.offset, g.num_nodes) for g in mine] == [
            (g.degree, g.offset, g.num_nodes) for g in theirs
        ]


def test_dvbs2_does_not_fit_the_shared_memory_kernels(dvbs2):
    layout = dvbs2[0]
    tables = DecoderConfig.load(f"{CONFIGS}/dvbs2_T16_0.6.npz").tables
    assert not fused_fits(layout, tables) and not fused_fits(layout, None)
    with pytest.raises(ValueError, match="shared memory"):
        pick_batch_tile(layout, 16, 16)
    with pytest.raises(ValueError, match="shared memory"):
        pick_float_batch_tile(layout)
    check_view_tile(layout, 128)  # 29M elements per view tile: int32 indexing holds
    with pytest.raises(ValueError, match="int32"):
        check_view_tile(layout, 9469)


# -- K3's twin against the JAX device-memory IB kernel (interpret mode) ----------

@pytest.mark.parametrize(
    "code, batch, reliable, early_exit",
    [
        ("ira", 8, False, False),  # random clusters, all i_max - 1 bodies
        ("ira", 8, True, True),  # the tile exits early
        ("qc96", 20, False, False),  # three tiles, the last one padded
    ],
)
def test_hbm_ib_twin_matches_jax_kernel(ira, qc96, code, batch, reliable, early_exit):
    c = {"ira": ira, "qc96": qc96}[code]
    layout, tables = c["layout"], c["tables"]
    ch = _clusters(reliable, (layout.n_vars, batch), seed=batch)
    dec = HBMFusedIBDecoder(layout, tables, early_exit=early_exit, batch_tile=8)
    got = dec(ch)
    want = JaxHBMFusedIBDecoder(
        c["jlayout"], c["jtables"], early_exit=early_exit, batch_tile=8, interpret=True
    )(jnp.asarray(ch.numpy()))
    assert got.outputs.dtype == torch.int32
    assert np.array_equal(got.outputs.numpy(), np.asarray(want.outputs))
    assert np.array_equal(got.unsatisfied.numpy(), np.asarray(want.unsatisfied))
    assert float(got.iterations) == float(want.iterations)
    assert dec.launches == dec.packed_launches == 0  # the CPU twin launches no kernel
    if early_exit:
        assert float(got.iterations) < tables.i_max - 1  # the exit fired


def test_hbm_ib_decoder_defaults_and_refusals(qc96):
    layout, tables = qc96["layout"], qc96["tables"]
    dec = HBMFusedIBDecoder(layout, tables)
    assert isinstance(dec, FusedIBDecoder) and dec.batch_tile == 128
    assert dec.imax == tables.i_max
    with pytest.raises(ValueError, match="max_iters"):
        HBMFusedIBDecoder(layout, tables, max_iters=tables.i_max + 1)
    with pytest.raises(ValueError, match="no kernel"):
        dec(torch.zeros((layout.n_vars, 4), dtype=torch.int32, device="meta"))


# -- K4's twin against the JAX device-memory float kernel (interpret mode) -------

@pytest.mark.parametrize("rule, max_iters", [("minsum", 6), ("bp", 5)])
def test_hbm_float_twin_matches_jax_kernel(ira, rule, max_iters):
    layout = ira["layout"]
    llrs = _llrs(0, (layout.n_vars, 8))
    dec = HBMFloatDecoder(layout, rule, max_iters=max_iters, early_exit=False, batch_tile=8)
    got = dec(llrs)
    want = JaxHBMFloatDecoder(
        ira["jlayout"], rule, max_iters=max_iters, early_exit=False, batch_tile=8,
        interpret=True,
    )(jnp.asarray(llrs.numpy()))
    if rule == "minsum":
        assert _equal(got.outputs, want.outputs)
    else:
        _close_bp(got.outputs, want.outputs)
    assert np.array_equal(got.unsatisfied.numpy(), np.asarray(want.unsatisfied))
    assert float(got.iterations) == float(want.iterations) == max_iters - 1
    assert dec.launches == 0


def test_hbm_float_exits_after_the_converged_body(ira):
    """The port's exit convention (the plain decoder's) against the JAX
    kernel's, which tests the syndrome one body later: on the high-SNR
    single-tile case of tests/test_float_hbm.py the port equals the JAX
    whole-batch min_sum_decode, and the JAX kernel reports one more
    iteration."""
    layout = ira["layout"]
    llrs = _llrs(1, (layout.n_vars, 8), mean=2.5, std=1.0)
    got = HBMFloatDecoder(layout, "minsum", max_iters=30, early_exit=True, batch_tile=8)(llrs)
    want = jax_min_sum_decode(ira["jlayout"], jnp.asarray(llrs.numpy()), max_iters=30, early_exit=True)
    assert int(want.iterations) < 29  # the exit fired
    assert _equal(got.outputs, want.outputs)
    assert np.array_equal(got.unsatisfied.numpy(), np.asarray(want.unsatisfied))
    assert float(got.iterations) == float(want.iterations)
    late = JaxHBMFloatDecoder(
        ira["jlayout"], "minsum", max_iters=30, early_exit=True, batch_tile=8, interpret=True
    )(jnp.asarray(llrs.numpy()))
    assert float(late.iterations) == float(got.iterations) + 1


@pytest.mark.parametrize("rule", ["minsum", "bp"])
def test_hbm_float_one_iteration_runs_no_body(qc96, rule):
    """i_max 1: the syndrome of the seeded view and a zero VN view, as the
    JAX kernel's test_float_hbm_degenerate_one_iter."""
    layout = qc96["layout"]
    llrs = _llrs(2, (layout.n_vars, 8))
    got = HBMFloatDecoder(layout, rule, max_iters=1, batch_tile=8)(llrs)
    want = JaxHBMFloatDecoder(
        qc96["jlayout"], rule, max_iters=1, early_exit=True, batch_tile=8, interpret=True
    )(jnp.asarray(llrs.numpy()))
    assert _equal(got.outputs, want.outputs)
    assert _equal(got.outputs, llrs)  # the channel plus a zero sum
    assert np.array_equal(got.unsatisfied.numpy(), np.asarray(want.unsatisfied))
    assert float(got.iterations) == float(want.iterations) == 0.0


def test_hbm_float_decoder_defaults(qc96):
    dec = HBMFloatDecoder(qc96["layout"], "bp", max_iters=3)
    assert isinstance(dec, FusedFloatDecoder) and dec.batch_tile == 128
    with pytest.raises(ValueError, match="rule"):
        HBMFloatDecoder(qc96["layout"], "sum-product")


def test_hbm_launch_refuses_before_the_card(dvbs2, qc96):
    """The wrappers refuse what the kernels do not take before any CUDA call
    (meta tensors stand in for CUDA ones)."""
    layout = qc96["layout"]
    ib = HBMFusedIBDecoder(layout, qc96["tables"])
    with pytest.raises(TypeError, match="int32"):
        ib._launch(torch.zeros((layout.n_vars, 4), device="meta"))
    with pytest.raises(ValueError, match=r"\[96, batch\]"):
        ib._launch(torch.zeros((95, 4), dtype=torch.int32, device="meta"))
    wide = HBMFloatDecoder(dvbs2[0], "minsum", batch_tile=16384)
    with pytest.raises(ValueError, match="int32 indexing"):
        wide._launch(torch.zeros((64800, 4), device="meta"))


@pytest.mark.parametrize(
    "dtype, t, row",
    [
        (torch.float32, None, 8),  # K4: float32 views
        (torch.uint8, 16, 4),  # K3 at |T| = 16: two 4-bit columns a byte
        (torch.uint8, 32, 8),  # K3 at |T| = 32: a byte a column
    ],
)
def test_tile_scratch_shapes(qc96, dtype, t, row):
    layout = qc96["layout"]
    packed = t is not None and view_bits(t, t) == 4
    a, b, chg, unsat, state = tile_scratch(
        layout, 20, 8, dtype, "cpu", zero_vn_view=True, packed=packed
    )
    assert a.shape == b.shape == (3, layout.n_edges, row) and a.dtype == dtype
    assert chg.shape == (3, layout.n_vars, row) and chg.dtype == dtype and not b.any()
    assert unsat.shape == (3, 8) and state.shape == (3, 2) and state.dtype == torch.int32


@pytest.mark.parametrize(
    "t_channel, t_decoder, bits",
    [(16, 16, 4), (8, 16, 4), (8, 8, 4), (16, 32, 8), (32, 32, 8), (17, 17, 8)],
)
def test_k3_view_width_follows_the_tables(t_channel, t_decoder, bits):
    """4 bits a message exactly when |T_ch| <= 16 and |T| <= 16."""
    assert view_bits(t_channel, t_decoder) == bits


@pytest.mark.parametrize(
    "model, config, bits",
    [("dvbs2-64800", "dvbs2_T16_0.6", 4), ("wlan-1296", "wlan_T16_0.8", 4),
     ("wlan-1296", "wlan_T32_0.6", 8)],
)
def test_k3_decoder_takes_its_width_from_its_tables(dvbs2, model, config, bits):
    layout = dvbs2[0] if model == "dvbs2-64800" else get_model(model).make_layout()
    tables = DecoderConfig.load(f"{CONFIGS}/{config}.npz").tables
    dec = HBMFusedIBDecoder(layout, tables)
    assert dec.view_bits == bits
    assert dec.launches == dec.packed_launches == 0


def pack_nibbles(x: torch.Tensor) -> torch.Tensor:
    """K3's packed rows, plainly: uint8 values below 16 in ``[..., columns]``
    -> ``[..., columns / 2]`` bytes, column 2k in the low nibble of byte k
    and column 2k + 1 in its high nibble (``csrc/ib_lut_hbm.cu``)."""
    return x[..., 0::2] | (x[..., 1::2] << 4)


def unpack_nibbles(p: torch.Tensor) -> torch.Tensor:
    return torch.stack((p & 15, p >> 4), dim=-1).flatten(-2)


def test_packed_rows_hold_two_columns_a_byte():
    """The layout of K3's 4-bit views: every pair of the 16 values round
    trips, column 2k takes the low nibble of byte k and column 2k + 1 its
    high nibble, so the V columns of a thread (``hbm_wide.cuh`` Nibbles) are
    the little-endian word of its V / 2 bytes with column j at bits 4j."""
    pairs = torch.cartesian_prod(torch.arange(16), torch.arange(16)).to(torch.uint8)
    x = pairs.reshape(2, 256)  # rows of 256 columns
    p = pack_nibbles(x)
    assert p.shape == (2, 128) and p.dtype == torch.uint8
    assert torch.equal(unpack_nibbles(p), x)
    assert torch.equal(p.to(torch.int32), x[:, 0::2].to(torch.int32) + 16 * x[:, 1::2].to(torch.int32))
    assert sorted(set(pack_nibbles(pairs.reshape(1, -1))[0].tolist())) == list(range(256))
    row = torch.tensor([1, 2, 3, 4, 5, 6, 7, 8], dtype=torch.uint8)
    assert pack_nibbles(row).tolist() == [0x21, 0x43, 0x65, 0x87]
    for v in (4, 8):  # Nibbles<4>: one 16-bit access; Nibbles<8>: one 32-bit access
        for chunk in x[0].reshape(-1, v):
            word = int.from_bytes(bytes(pack_nibbles(chunk).tolist()), "little")
            assert [(word >> (4 * j)) & 15 for j in range(v)] == chunk.tolist()


@pytest.mark.parametrize("t", [2, 8, 16, 32, 12])
def test_check_syndrome_from_one_xor_of_the_rows(t):
    """K3's check-node syndrome where |T| is a power of two: the parity of
    the inputs' hard decisions (t < |T| / 2) is bit |T| / 2 of their XOR,
    flipped at odd degrees. At |T| = 12 it is not, so the kernel keeps the
    per-message compare for such tables."""
    rng = np.random.default_rng(t)
    same = []
    for d in range(2, 17):
        m = rng.integers(0, t, (d, 256))
        want = np.bitwise_xor.reduce(m < t // 2, axis=0)
        got = (np.bitwise_xor.reduce(m, axis=0) & (t // 2) != 0) != (d % 2 == 1)
        same.append(np.array_equal(got, want))
    assert all(same) if t & (t - 1) == 0 else not any(same)


def test_packed_launches_stay_zero_on_the_cpu_twin(qc96):
    layout, tables = qc96["layout"], qc96["tables"]
    dec = HBMFusedIBDecoder(layout, tables, batch_tile=8)
    assert dec.view_bits == 4  # the card would pack these tables
    got = dec(_clusters(False, (layout.n_vars, 16), seed=5))
    assert got.outputs.shape == (layout.n_vars, 16)
    assert dec.launches == dec.packed_launches == 0


# -- the engine's backend ------------------------------------------------------

@pytest.mark.parametrize("decoder", ["ib", "minsum", "bp"])
@pytest.mark.parametrize("model", ["dvbs2-64800", "wlan-1296"])
def test_auto_backend_picks_by_layout(dvbs2, decoder, model):
    if model == "dvbs2-64800":
        layout, config, backend = dvbs2[0], "dvbs2_T16_0.6", "hbm"
        kinds = {"ib": HBMFusedIBDecoder, "float": HBMFloatDecoder}
    else:
        layout, config, backend = get_model(model).make_layout(), "wlan_T16_0.8", "fused"
        kinds = {"ib": FusedIBDecoder, "float": FusedFloatDecoder}
    kw = dict(max_iters=50)
    if decoder == "ib":
        tables = DecoderConfig.load(f"{CONFIGS}/{config}.npz").tables
        kw = dict(trellis=DeviceTrellis.from_tables(tables, "cpu"))
    sim = BERSimulator(layout, decoder, device="cpu", **kw)
    assert sim.backend == backend
    want = kinds["ib" if decoder == "ib" else "float"]
    assert type(sim.fused_decoder) is want
    if decoder != "ib":
        assert sim.fused_decoder.rule == decoder


def test_fused_backend_refuses_dvbs2_and_xla_is_not_ported(dvbs2):
    layout = dvbs2[0]
    with pytest.raises(ValueError, match="shared memory"):
        BERSimulator(layout, "minsum", device="cpu", max_iters=50, backend="fused")
    tables = DecoderConfig.load(f"{CONFIGS}/dvbs2_T16_0.6.npz").tables
    trellis = DeviceTrellis.from_tables(tables, "cpu")
    with pytest.raises(ValueError, match="shared memory"):
        BERSimulator(layout, "ib", device="cpu", trellis=trellis, backend="fused")
    # 'xla' is the whole-batch path, chosen only by name.
    sim = BERSimulator(layout, "ib", device="cpu", trellis=trellis, backend="xla")
    assert sim.backend == "xla" and isinstance(sim.fused_decoder, WholeBatchDecoder)
    with pytest.raises(ValueError, match="batch_tile"):
        BERSimulator(layout, "ib", device="cpu", trellis=trellis, backend="xla", batch_tile=128)
    with pytest.raises(ValueError, match="backend"):
        BERSimulator(layout, "bp", device="cpu", max_iters=5, backend="tpu")


@pytest.mark.parametrize("decoder", ["ib", "minsum"])
def test_encoded_hbm_step_matches_jax_chain(ira, decoder):
    """One encoded step on the IRA code through ``backend='hbm'`` with the
    tile = the batch (whole-batch lockstep): the same counters as the JAX
    chain (its XLA decoder) on the same numpy info bits and received plane,
    as tests/test_torch_encode.py does for WLAN."""
    batch, ebn0_db = 8, 2.0
    enc = LDPCEncoder(ira["H"])
    assert enc.is_staircase
    kw = dict(
        max_iters=5, chain="encoded", cardinality_t_channel=16,
        cardinality_y_channel=400, batch_per_device=batch, encoder=enc,
    )
    jkw = dict(kw)
    if decoder == "ib":
        kw["trellis"] = DeviceTrellis.from_tables(ira["tables"], "cpu")
        jkw["trellis"] = JaxTrellis.from_tables(ira["jtables"])
    port = BERSimulator(
        ira["layout"], decoder, device="cpu", backend="hbm", batch_tile=batch, **kw
    )
    assert isinstance(port.fused_decoder, (HBMFusedIBDecoder, HBMFloatDecoder))
    jkw["encoder"] = JaxEncoder(ira["H"])
    jsim = JaxSimulator(ira["jlayout"], decoder, n_devices=1, backend="xla", **jkw)

    rng = np.random.default_rng(5)
    info = rng.integers(0, 2, (enc.k, batch)).astype(np.int8)
    sigma2 = port.sigma2_for(ebn0_db)
    jcw = jsim._encode_device(jnp.asarray(info))
    cw = port._encode(torch.as_tensor(info))
    assert np.array_equal(cw.numpy(), np.asarray(jcw))
    y = (
        1.0 - 2.0 * np.asarray(jcw, np.float32)
        + np.float32(np.sqrt(sigma2)) * rng.standard_normal(cw.shape, dtype=np.float32)
    ).astype(np.float32)
    qt, jqt = port.quantizer_for(ebn0_db), jsim.quantizer_for(ebn0_db)
    ch = from_received(port._consumer, torch.as_tensor(y), qt, sigma2)
    res = jsim._decode(jnp.asarray(ch.numpy()), None)
    per_cw = jsim._count_errors(res.outputs, jcw)
    errors, frame_errors, iterations = port.decode_and_count(ch, cw)
    assert int(errors) == int(jnp.sum(per_cw)) > 0
    assert int(frame_errors) == int(jnp.sum(per_cw > 0))
    assert float(iterations) == float(res.iterations)
