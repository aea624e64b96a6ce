"""The PyTorch port's IB decoder and fused-kernel twin against the JAX package.

Inputs are made with numpy from a seed and fed to both sides; every
comparison is exact integer equality. The WLAN cases compare with the JAX
XLA decoder ``ib_lut_decode``; the tiled twin of the CUDA kernel compares
with the JAX Pallas kernel run in interpret mode on the 96-variable QC code
(the fixture of tests/test_fused_kernel.py), where the interpreter is quick.
The plain decoder is also held against the scalar reference decoder of
tests/reference_impls.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from informationbottleneckdecodingldpc_tpu.channel import quantizer as jax_quant
from informationbottleneckdecodingldpc_tpu.codes import TannerGraph
from informationbottleneckdecodingldpc_tpu.codes.random_codes import (
    regular_qc_parity_check,
)
from informationbottleneckdecodingldpc_tpu.construct import (
    DecoderConfig as JaxConfig,
    build_decoder_config,
)
from informationbottleneckdecodingldpc_tpu.decode import (
    DecodeLayout as JaxLayout,
    DeviceTrellis as JaxTrellis,
    ib_lut_decode as jax_ib_lut_decode,
)
from informationbottleneckdecodingldpc_tpu.kernels import (
    FusedIBDecoder as JaxFusedIBDecoder,
)
from informationbottleneckdecodingldpc_tpu.models import get_model as jax_model
from informationbottleneckdecodingldpc_tpu.ops import lut_fold as jax_fold
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
from informationbottleneckdecodingldpc_torch.decode import (
    DecodeLayout,
    DeviceTrellis,
    ib_lut_decode,
)
from informationbottleneckdecodingldpc_torch.kernels import FusedIBDecoder
from informationbottleneckdecodingldpc_torch.models import get_model
from informationbottleneckdecodingldpc_torch.ops import lut_fold

CONFIGS = "results/configs"


@pytest.fixture(scope="module")
def wlan():
    return get_model("wlan-1296").make_layout(), jax_model("wlan-1296").make_layout()


def _config(name):
    path = f"{CONFIGS}/{name}.npz"
    return DecoderConfig.load(path), JaxConfig.load(path)


def _sampled_clusters(ebn0_db, t_channel, shape, seed, cardinality_y=2000):
    """Clusters sampled on both sides from one numpy uniform plane; the two
    quantizers' tables and samples must agree exactly."""
    sigma2 = sigma2_from_ebn0_db(ebn0_db, 0.5)
    qt = build_quantizer_tables(sigma2, 3.0, t_channel, cardinality_y)
    jqt = jax_quant.build_quantizer_tables(sigma2, 3.0, t_channel, cardinality_y)
    for f in ("limits", "cdf_t_given_x0", "output_llrs", "p_x_and_t"):
        assert np.array_equal(getattr(qt, f), getattr(jqt, f))
    u = np.random.default_rng(seed).random(shape, dtype=np.float32)
    got = sample_clusters_from_uniform(
        device_tables(qt, "cpu").cdf,
        torch.as_tensor(u),
        torch.zeros(shape, dtype=torch.int32),
    )
    want = jax_quant.sample_clusters_from_uniform(
        jax_quant.device_tables(jqt).cdf, jnp.asarray(u), jnp.zeros(shape, jnp.int32)
    )
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))
    return got


def _assert_same(got, want, iterations_as=int):
    assert got.outputs.dtype == torch.int32
    assert np.array_equal(got.outputs.numpy(), np.asarray(want.outputs))
    assert np.array_equal(got.unsatisfied.numpy(), np.asarray(want.unsatisfied))
    assert iterations_as(got.iterations) == iterations_as(want.iterations)


@pytest.mark.parametrize(
    "config, ebn0_db, max_iters, early_exit",
    [
        ("wlan_T16_0.8", None, 5, False),  # random clusters
        ("wlan_T16_0.8", 6.0, 50, True),  # sampled clusters, exits early
        ("wlan_T32_0.6", None, 5, False),
    ],
)
def test_wlan_ib_lut_decode_matches_jax(wlan, config, ebn0_db, max_iters, early_exit):
    layout, jlayout = wlan
    cfg, jcfg = _config(config)
    tch = cfg.tables.cardinality_t_channel
    shape = (layout.n_vars, 8)
    if ebn0_db is None:
        ch = torch.as_tensor(
            np.random.default_rng(0).integers(0, tch, shape).astype(np.int32)
        )
    else:
        ch = _sampled_clusters(ebn0_db, tch, shape, seed=0)
    got = ib_lut_decode(
        layout,
        DeviceTrellis.from_tables(cfg.tables, "cpu"),
        ch,
        max_iters=max_iters,
        early_exit=early_exit,
    )
    want = jax_ib_lut_decode(
        jlayout,
        JaxTrellis.from_tables(jcfg.tables),
        jnp.asarray(ch.numpy()),
        max_iters=max_iters,
        early_exit=early_exit,
    )
    _assert_same(got, want)
    if early_exit:
        assert int(got.iterations) < max_iters - 1  # early exit fired


@pytest.mark.parametrize("code", ["qc-96", "wlan-1296"])
def test_ib_lut_decode_matches_brute_force_reference(code, qc96, wlan):
    """Per codeword (batch 1, so lockstep is per codeword) against the
    reference kernels' scalar loops in tests/reference_impls.py."""
    from reference_impls import brute_lut_decode

    if code == "qc-96":
        layout, tables = qc96[0], qc96[2]
        H, max_iters = regular_qc_parity_check(96, 3, 6, seed=7), None
    else:
        layout, tables = wlan[0], _config("wlan_T16_0.8")[0].tables
        H, max_iters = get_model("wlan-1296").make_h(), 4
    trellis = DeviceTrellis.from_tables(tables, "cpu")
    H = H.toarray() if hasattr(H, "toarray") else H
    ch = _sampled_clusters(4.0, 16, (layout.n_vars, 3), seed=3, cardinality_y=400)
    for b in range(3):
        got = ib_lut_decode(layout, trellis, ch[:, b : b + 1], max_iters=max_iters)
        out, iters, unsat = brute_lut_decode(
            H, tables, ch[:, b].numpy(), max_iters or tables.i_max
        )
        assert np.array_equal(got.outputs[:, 0].numpy(), out)
        assert int(got.iterations) == iters
        assert int(got.unsatisfied[0]) == unsat


def test_message_syndrome_flickers_as_in_the_reference(wlan):
    """IB early exit at 2.4 dB on WLAN |T|=16: per codeword (batch 1), the
    port's decoder, the JAX decoder and the scalar reference of
    tests/reference_impls.py leave after the same body, the first at which
    the variable-to-check messages satisfy every check. The messages keep
    moving after it: without early exit, a codeword whose syndrome was zero
    after body 10 has 2 unsatisfied checks after body 11, in the port (the
    counts after b bodies from a decode of b bodies) and in the reference
    alike. A tile exits only when all its codewords are zero after the same
    body."""
    from reference_impls import brute_lut_decode

    layout, jlayout = wlan
    cfg, jcfg = _config("wlan_T16_0.8")
    trellis = DeviceTrellis.from_tables(cfg.tables, "cpu")
    H = get_model("wlan-1296").make_h().toarray()
    sigma2 = sigma2_from_ebn0_db(2.4, 0.5)
    qt = device_tables(build_quantizer_tables(sigma2, 3.0, 16, 2000), "cpu")
    u = torch.as_tensor(np.random.default_rng(11).random((layout.n_vars, 4), dtype=np.float32))
    ch = sample_clusters_from_uniform(qt.cdf, u, torch.zeros_like(u, dtype=torch.int32))
    counts = np.array([
        ib_lut_decode(layout, trellis, ch, max_iters=b + 1, early_exit=False).unsatisfied.tolist()
        for b in range(1, 20)
    ])  # [bodies, codewords]
    for b in (0, 2, 3):
        got = ib_lut_decode(layout, trellis, ch[:, b : b + 1])
        first_zero = int(np.argmax(counts[:, b] == 0)) + 1
        want = jax_ib_lut_decode(jlayout, JaxTrellis.from_tables(jcfg.tables),
                                 jnp.asarray(ch[:, b : b + 1].numpy()))
        _, iters, unsat = brute_lut_decode(H, cfg.tables, ch[:, b].numpy(), cfg.tables.i_max)
        assert int(got.iterations) == first_zero == int(want.iterations) == iters < 20
        assert unsat == 0
    assert counts[9, 3] == 0 and counts[10, 3] == 2
    _, iters, unsat = brute_lut_decode(H, cfg.tables, ch[:, 3].numpy(), 12, early_exit=False)
    assert (iters, unsat) == (11, 2)


def test_device_trellis_carries_the_tables():
    cfg, _ = _config("wlan_T16_0.8")
    tr = DeviceTrellis.from_tables(cfg.tables, "cpu")
    assert (tr.t_channel, tr.t_decoder, tr.i_max) == (16, 16, 50)
    assert tuple(tr.cn_rest.shape) == (49, 6, 16, 16)
    assert tuple(tr.matching_vn.shape) == (50, 11, 16)
    assert np.array_equal(tr.vn_rest.numpy(), cfg.tables.vn_rest)
    assert DeviceTrellis.from_tables(cfg.tables, "cpu", use_matching=False).matching_cn is None


@pytest.mark.parametrize("degree", [2, 3, 4, 7, 11])
def test_leave_one_out_folds_match_jax(degree):
    rng = np.random.default_rng(degree)
    T = 16
    luts = [rng.integers(0, T, (T, T)) for _ in range(degree)]
    msgs = rng.integers(0, T, (degree, 5, 3))
    ch = rng.integers(0, T, (5, 3))
    t = lambda a: torch.as_tensor(a, dtype=torch.int64)
    j = lambda a: jnp.asarray(a, jnp.int32)
    pairs = [
        (
            lut_fold.cn_lut_leave_one_out(t(msgs), [t(l) for l in luts[: degree - 2]]),
            jax_fold.cn_lut_leave_one_out(j(msgs), [j(l) for l in luts[: degree - 2]], vmax=T),
        ),
        (
            lut_fold.vn_lut_leave_one_out(t(ch), t(msgs), t(luts[0]), [t(l) for l in luts[1 : degree - 1]]),
            jax_fold.vn_lut_leave_one_out(j(ch), j(msgs), j(luts[0]), [j(l) for l in luts[1 : degree - 1]], vmax=T),
        ),
        (
            lut_fold.vn_lut_full_fold(t(ch), t(msgs), t(luts[0]), [t(l) for l in luts[1:]]),
            jax_fold.vn_lut_full_fold(j(ch), j(msgs), j(luts[0]), [j(l) for l in luts[1:]], vmax=T),
        ),
        (
            lut_fold.vector_lookup(t(luts[0][0]), t(msgs)),
            jax_fold.vector_lookup(j(luts[0][0]), j(msgs), vmax=T),
        ),
    ]
    for got, want in pairs:
        assert np.array_equal(got.numpy(), np.asarray(want))


# -- the CUDA kernel's plain twin vs the JAX Pallas kernel ----------------


@pytest.fixture(scope="module")
def qc96():
    g = TannerGraph.from_check_matrix(regular_qc_parity_check(96, 3, 6, seed=7))
    cfg = build_decoder_config(
        design_ebn0_db=2.0,
        cardinality_y_channel=400,
        cardinality_t_channel=16,
        cardinality_t_decoder=16,
        i_max=6,
        d_v=3,
        d_c=6,
    )
    tables = TrellisTables(**dataclasses.asdict(cfg.tables))
    return DecodeLayout.from_graph(g), JaxLayout.from_graph(g), tables, cfg.tables


@pytest.mark.parametrize(
    "batch, batch_tile, ebn0_db",
    [
        (24, 8, 4.0),  # three tiles exit at different iterations
        (16, 16, None),  # one tile: whole-batch lockstep, random clusters
    ],
)
def test_fused_twin_matches_jax_pallas_kernel(qc96, batch, batch_tile, ebn0_db):
    layout, jlayout, tables, jtables = qc96
    shape = (layout.n_vars, batch)
    if ebn0_db is None:
        ch = torch.as_tensor(np.random.default_rng(1).integers(0, 16, shape).astype(np.int32))
    else:
        ch = _sampled_clusters(ebn0_db, 16, shape, seed=0, cardinality_y=400)
    dec = FusedIBDecoder(layout, tables, early_exit=True, batch_tile=batch_tile)
    got = dec(ch)
    want = JaxFusedIBDecoder(
        jlayout, jtables, early_exit=True, batch_tile=batch_tile, interpret=True
    )(jnp.asarray(ch.numpy()))
    _assert_same(got, want, iterations_as=float)
    assert got.iterations.dtype == torch.float32
    assert dec.launches == 0  # the CPU twin launches no kernel
    if ebn0_db is not None:
        per_tile = [
            int(ib_lut_decode(layout, dec.trellis("cpu"), ch[:, b : b + batch_tile]).iterations)
            for b in range(0, batch, batch_tile)
        ]
        assert len(set(per_tile)) > 1
        assert float(got.iterations) == pytest.approx(np.mean(per_tile))


def test_fused_twin_pads_the_last_tile(qc96):
    layout, _, tables, _ = qc96
    ch = torch.as_tensor(np.random.default_rng(2).integers(0, 16, (layout.n_vars, 10)).astype(np.int32))
    dec = FusedIBDecoder(layout, tables, early_exit=False, batch_tile=8)
    got = dec(ch)
    # Fixed iterations: tiling, padding included, changes nothing.
    ref = ib_lut_decode(layout, dec.trellis("cpu"), ch, early_exit=False)
    assert torch.equal(got.outputs, ref.outputs)
    assert torch.equal(got.unsatisfied, ref.unsatisfied)
    assert float(got.iterations) == float(ref.iterations) == 5.0


def test_fused_decoder_rejects_what_the_kernel_does_not_take(qc96):
    layout, _, tables, _ = qc96
    with pytest.raises(ValueError, match="max_iters"):
        FusedIBDecoder(layout, tables, max_iters=7)
    wide = dataclasses.replace(tables, cardinality_t_channel=32)
    with pytest.raises(ValueError, match="T_ch"):
        FusedIBDecoder(layout, wide)
    dec = FusedIBDecoder(layout, tables)
    with pytest.raises(ValueError, match="no kernel"):
        dec(torch.zeros((layout.n_vars, 4), dtype=torch.int32, device="meta"))
