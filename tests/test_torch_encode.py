"""The PyTorch port's encoded BPSK chain against the JAX package.

The device encoder is held bit for bit against the host ``LDPCEncoder`` on
WLAN (dense GF(2) inverse of B) and a DVB-S2-like code (staircase B). The
whole slice: the same numpy info bits and received plane ``y`` go through
the JAX engine's pieces (device encoder, quantizer, XLA decoder, error
count) and through the port's ``rng.from_received`` and
``decode_and_count``; the counters must be equal, and BP's outputs stay
within the stated tolerance.
``y`` is injected because XLA on the CPU contracts ``bpsk + sqrt(s2) * n``
into one FMA where torch rounds the product first: that line is checked on
its own, within one float32 ULP.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from informationbottleneckdecodingldpc_tpu.channel import quantizer as jax_quant
from informationbottleneckdecodingldpc_tpu.channel.modulation import (
    bpsk_map as jax_bpsk_map,
)
from informationbottleneckdecodingldpc_tpu.codes.dvbs2 import dvbs2_like_parity_check
from informationbottleneckdecodingldpc_tpu.construct import DecoderConfig as JaxConfig
from informationbottleneckdecodingldpc_tpu.decode import DeviceTrellis as JaxTrellis
from informationbottleneckdecodingldpc_tpu.encode import LDPCEncoder as JaxEncoder
from informationbottleneckdecodingldpc_tpu.models import get_model as jax_model
from informationbottleneckdecodingldpc_tpu.sim import BERSimulator as JaxSimulator
from informationbottleneckdecodingldpc_tpu.sim.engine import PointResult as JaxPoint
from informationbottleneckdecodingldpc_torch.channel import sigma2_from_ebn0_db
from informationbottleneckdecodingldpc_torch.cli import simulate
from informationbottleneckdecodingldpc_torch.construct import DecoderConfig
from informationbottleneckdecodingldpc_torch.decode import DeviceTrellis
from informationbottleneckdecodingldpc_torch.encode import LDPCEncoder, device_encoder
from informationbottleneckdecodingldpc_torch.models import get_model
from informationbottleneckdecodingldpc_torch.sim import BERSimulator
from informationbottleneckdecodingldpc_torch.channel.awgn import received_plane
from informationbottleneckdecodingldpc_torch.sim.rng import from_received

CONFIG = "results/configs/wlan_T16_0.8.npz"
BP_RTOL = 1e-5  # as in tests/test_torch_float.py
JAX_POINT_KEYS = {f.name for f in dataclasses.fields(JaxPoint)}


@pytest.fixture(scope="module")
def wlan():
    H = get_model("wlan-1296").make_h()
    return H, get_model("wlan-1296").make_layout(H), LDPCEncoder(H)


@pytest.mark.parametrize("code", ["wlan-1296", "dvbs2-like-6480"])
def test_device_encoder_matches_host_encoder(code, wlan):
    if code == "wlan-1296":
        enc = wlan[2]
        assert not enc.is_staircase  # the dense-inverse path
    else:
        enc = LDPCEncoder(dvbs2_like_parity_check(6480, 3240, seed=2))
        assert enc.is_staircase  # the prefix-XOR path
    info = np.random.default_rng(3).integers(0, 2, (enc.k, 24)).astype(np.int8)
    got = device_encoder(enc, "cpu")(torch.as_tensor(info))
    assert got.dtype == torch.int8 and tuple(got.shape) == (enc.n, 24)
    assert np.array_equal(got.numpy(), enc.encode(info))
    assert not enc.check(got.numpy()).any()  # every codeword is valid
    jax_cw = JaxEncoder(enc.H).device_encoder()(jnp.asarray(info))
    assert np.array_equal(got.numpy(), np.asarray(jax_cw))


def test_received_plane_within_one_ulp_of_jax():
    rng = np.random.default_rng(11)
    bits = rng.integers(0, 2, (1296, 64)).astype(np.int8)
    noise = rng.standard_normal((1296, 64), dtype=np.float32)
    sigma2 = float(np.float32(sigma2_from_ebn0_db(1.2, 0.5)))
    got = received_plane(torch.as_tensor(bits), torch.as_tensor(noise), sigma2).numpy()
    want = np.asarray(
        jax.jit(lambda b, n, s: jax_bpsk_map(b) + jnp.sqrt(s) * n)(
            jnp.asarray(bits), jnp.asarray(noise), jnp.float32(sigma2)
        )
    )
    # The FMA skips the product's rounding: one ULP of the larger of |y| and
    # |sqrt(s2) n| bounds the difference.
    product = np.abs(np.float32(np.sqrt(sigma2)) * noise)
    assert np.all(np.abs(got - want) <= np.spacing(np.maximum(np.abs(want), product)))


def _sims(wlan, decoder, llr_source="quantized", batch=8):
    H, layout, enc = wlan
    kw = dict(
        max_iters=5,
        chain="encoded",
        llr_source=llr_source,
        cardinality_t_channel=16,
        batch_per_device=batch,
        early_exit=True,
        encoder=enc,
    )
    jkw = {}
    if decoder == "ib":
        kw["trellis"] = DeviceTrellis.from_tables(DecoderConfig.load(CONFIG).tables, "cpu")
        jkw["trellis"] = JaxTrellis.from_tables(JaxConfig.load(CONFIG).tables)
    port = BERSimulator(layout, decoder, device="cpu", batch_tile=batch, **kw)
    kw.update(jkw, encoder=JaxEncoder(H))
    jax_sim = JaxSimulator(
        jax_model("wlan-1296").make_layout(H), decoder, n_devices=1, backend="xla", **kw
    )
    return port, jax_sim


@pytest.mark.parametrize("decoder", ["ib", "minsum", "bp"])
def test_encoded_step_matches_jax_chain(wlan, decoder):
    port, jsim = _sims(wlan, decoder)
    batch, ebn0_db = 8, 1.2
    rng = np.random.default_rng(5)
    info = rng.integers(0, 2, (wlan[2].k, batch)).astype(np.int8)
    sigma2 = port.sigma2_for(ebn0_db)

    jcw = jsim._encode_device(jnp.asarray(info))
    cw = port._encode(torch.as_tensor(info))
    assert np.array_equal(cw.numpy(), np.asarray(jcw))
    y = (
        1.0 - 2.0 * np.asarray(jcw, np.float32)
        + np.float32(np.sqrt(sigma2)) * rng.standard_normal(cw.shape, dtype=np.float32)
    ).astype(np.float32)

    qt, jqt = port.quantizer_for(ebn0_db), jsim.quantizer_for(ebn0_db)
    for got, want in zip(qt, jqt):
        assert np.array_equal(got.numpy(), np.asarray(want))
    if decoder == "ib":
        jch = jax_quant.quantize_with(jqt.limits, jnp.asarray(y))
    else:
        jch = jax_quant.quantize_llr_with(jqt.limits, jqt.llrs, jnp.asarray(y))
    ch = from_received(port._consumer, torch.as_tensor(y), qt, sigma2)
    assert np.array_equal(ch.numpy(), np.asarray(jch))

    res = jsim._decode(jch, None)
    per_cw = jsim._count_errors(res.outputs, jcw)
    errors, frame_errors, iterations = port.decode_and_count(ch, cw)
    assert int(errors) == int(jnp.sum(per_cw)) > 0
    assert int(frame_errors) == int(jnp.sum(per_cw > 0))
    assert float(iterations) == float(res.iterations)
    if decoder == "bp":
        got = port.fused_decoder(ch).outputs.numpy()
        want = np.asarray(res.outputs)
        assert np.all(np.abs(got - want) <= BP_RTOL * np.maximum(1.0, np.abs(want)))


def test_true_llrs_match_jax(wlan):
    port, _ = _sims(wlan, "minsum", llr_source="true")
    sigma2 = port.sigma2_for(1.6)
    y = np.random.default_rng(2).normal(1.0, 0.8, (1296, 8)).astype(np.float32)
    got = from_received(port._consumer, torch.as_tensor(y), port.quantizer_for(1.6), sigma2)
    want = jax.jit(lambda y, s: 2.0 * y / s)(jnp.asarray(y), jnp.float32(sigma2))
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize(
    "decoder, chain, llr_source",
    [("minsum", "encoded", "quantized"), ("bp", "allzero", "true"), ("ib", "encoded", "quantized")],
)
def test_counters_do_not_depend_on_steps_per_dispatch(wlan, decoder, chain, llr_source):
    H, layout, enc = wlan
    kw = dict(
        device="cpu", max_iters=3, chain=chain, llr_source=llr_source,
        batch_per_device=4, encoder=enc,
    )
    if decoder == "ib":
        kw["trellis"] = DeviceTrellis.from_tables(DecoderConfig.load(CONFIG).tables, "cpu")
    one, two = (
        BERSimulator(layout, decoder, steps_per_dispatch=k, **kw).run_point(
            1.0, min_errors=10**9, max_blocks=8
        )
        for k in (1, 2)
    )
    assert (one.errors, one.frame_errors, one.blocks) == (
        two.errors, two.frame_errors, two.blocks,
    )
    assert one.blocks == 8 and one.errors > 0
    assert one.mean_iterations == 2.0  # max_iters - 1 at 1.0 dB


def test_float_decoders_require_max_iters(wlan):
    with pytest.raises(ValueError, match="max_iters"):
        BERSimulator(wlan[1], "bp", device="cpu")
    with pytest.raises(ValueError, match="LDPCEncoder"):
        BERSimulator(wlan[1], "minsum", device="cpu", max_iters=3, chain="encoded")


def test_cli_runs_the_encoded_min_sum_chain(tmp_path):
    out = tmp_path / "points.json"
    simulate.main([
        "--model", "wlan-1296", "--decoder", "minsum", "--chain", "encoded",
        "--device", "cpu", "--start-db", "1.0", "--max-db", "1.0",
        "--max-iters", "3", "--batch-per-device", "4", "--min-errors", "1",
        "--max-blocks-per-point", "4", "--no-early-exit", "--results", str(out),
    ])
    points = json.loads(out.read_text())["points"]
    assert [p["ebn0_db"] for p in points] == [1.0]
    assert set(points[0]) == JAX_POINT_KEYS
    assert points[0]["blocks"] == 4 and points[0]["mean_iterations"] == 2.0


@pytest.mark.parametrize(
    "argv",
    [
        ["--decoder", "ib"],  # ib needs --config
        ["--decoder", "ib", "--config", CONFIG, "--t-channel", "8"],
    ],
)
def test_cli_rejects_bad_decoder_options(tmp_path, argv):
    with pytest.raises(SystemExit):
        simulate.main([
            "--model", "wlan-1296", "--device", "cpu", *argv,
            "--results", str(tmp_path / "x.json"),
        ])
