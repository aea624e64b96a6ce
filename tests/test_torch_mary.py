"""The PyTorch port's M-ary chains (QAM and M-PSK through the exact soft
demapper) against the JAX package.

Inputs are made with numpy from a seed and fed to both sides. The tables,
the bit groups and the symbol maps use exact operations and are compared
with ``==``. The demappers go through ``exp`` and ``log``, whose last bits
differ between XLA and torch: their LLRs are held within
``LLR_RTOL`` * max(1, |ref|), measured at most 4.8e-7 (4 float32 ULPs of
max(1, |ref|)) over QAM 4/16/64 and 4/8/16-PSK at n0 0.02, 0.3 and 2.0 on
this file's data. Decoding the JAX package's LLRs, the port counts exactly
what the JAX engine counts (min-sum compares signs only). A Monte-Carlo step
of 2B codewords counts what its two B-wide shards count.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from informationbottleneckdecodingldpc_tpu.channel import awgn as jax_awgn
from informationbottleneckdecodingldpc_tpu.channel import demap as jax_demap
from informationbottleneckdecodingldpc_tpu.channel import modulation as jax_mod
from informationbottleneckdecodingldpc_tpu.encode import LDPCEncoder as JaxEncoder
from informationbottleneckdecodingldpc_tpu.models import get_model as jax_model
from informationbottleneckdecodingldpc_tpu.sim import BERSimulator as JaxSimulator
from informationbottleneckdecodingldpc_torch.channel import (
    LDPCTransmitter,
    Transmitter,
    awgn_transmit,
    ebn0_db_from_sigma2,
    gray_encoding_table,
    iq_to_complex,
    mpsk_bit_llrs,
    mpsk_map,
    n0_from_sigma2,
    qam_bit_llrs,
    qam_map,
    sigma2_from_ebn0_db,
)
from informationbottleneckdecodingldpc_torch.channel import modulation
from informationbottleneckdecodingldpc_torch.encode import LDPCEncoder
from informationbottleneckdecodingldpc_torch.models import get_model
from informationbottleneckdecodingldpc_torch.sim import BERSimulator, rng
from informationbottleneckdecodingldpc_torch.sim.engine import step_seed

LLR_RTOL = 2e-6
QAM_ORDERS = (2, 4, 8)  # sqrt(M): QAM-4, 16, 64
PSK_ORDERS = (4, 8, 16)


def _bits_per_symbol(kind, order):
    return 2 * int(np.log2(order)) if kind == "qam" else int(np.log2(order))


def _table(kind, order):
    k = _bits_per_symbol(kind, order)
    return gray_encoding_table(k // 2 if kind == "qam" else k)


def _close_llrs(got, want):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.all(np.abs(got - want) <= LLR_RTOL * np.maximum(1.0, np.abs(want)))


@pytest.fixture(scope="module")
def wlan():
    H = get_model("wlan-1296").make_h()
    return get_model("wlan-1296").make_layout(H), LDPCEncoder(H), H


# -- tables and maps ---------------------------------------------------------


@pytest.mark.parametrize("num_bits", [1, 2, 3, 4, 5])
def test_gray_and_constellation_tables_equal_jax(num_bits):
    table = gray_encoding_table(num_bits)
    assert table.dtype == np.int8
    assert np.array_equal(table, jax_mod.gray_encoding_table(num_bits))
    assert np.array_equal(modulation._natural_values(table), jax_mod._natural_values(table))
    m = 1 << num_bits
    for got, want in zip(modulation.qam_tables(table, m), jax_mod.qam_tables(table, m)):
        assert np.array_equal(got, want)
    assert np.array_equal(modulation.mpsk_tables(table, m), jax_mod.mpsk_tables(table, m))


def test_bit_group_values_equal_jax():
    bits = np.random.default_rng(0).integers(0, 2, (24, 5)).astype(np.int8)
    for k in (1, 2, 3, 4, 6):
        got = modulation._bit_group_values(torch.as_tensor(bits), k)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), np.asarray(jax_mod._bit_group_values(jnp.asarray(bits), k)))
    with pytest.raises(ValueError, match="not divisible"):
        modulation._bit_group_values(torch.as_tensor(bits), 5)


def test_bit_masks_equal_jax():
    for k in (1, 2, 3, 4, 5):
        assert np.array_equal(modulation._bit_masks(k, "cpu").numpy(), jax_demap._bit_masks(k))


@pytest.mark.parametrize("kind, order", [*(("qam", o) for o in QAM_ORDERS),
                                         *(("mpsk", o) for o in PSK_ORDERS)])
def test_symbol_maps_equal_jax_bit_for_bit(kind, order):
    k = _bits_per_symbol(kind, order)
    table = _table(kind, order)
    bits = np.random.default_rng(order).integers(0, 2, (k * 40, 6)).astype(np.int8)
    port = qam_map if kind == "qam" else mpsk_map
    ref = jax_mod.qam_map if kind == "qam" else jax_mod.mpsk_map
    got = port(torch.as_tensor(bits), table, order)
    want = np.asarray(ref(jnp.asarray(bits), table, order))
    assert got.dtype == torch.float32 and tuple(got.shape) == (40, 6, 2)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(iq_to_complex(got), jax_mod.iq_to_complex(want))


def test_transmitters_map_and_encode(wlan):
    layout, enc, H = wlan
    g = torch.Generator().manual_seed(1)
    sym, bits = Transmitter(96, "qam", 4).transmit(g, 3)
    assert tuple(bits.shape) == (96, 3) and bits.dtype == torch.int8
    assert torch.equal(sym, qam_map(bits, gray_encoding_table(2), 4))
    with pytest.raises(ValueError):
        Transmitter(8, "ask")
    sym, info, codeword = LDPCTransmitter(enc, "mpsk", 8).transmit(g, 2)
    assert tuple(info.shape) == (enc.k, 2) and tuple(sym.shape) == (layout.n_vars // 3, 2, 2)
    assert torch.equal(codeword[: enc.k], info)
    assert not (H @ codeword.numpy().astype(np.int64) % 2).any()
    assert torch.equal(sym, mpsk_map(codeword, gray_encoding_table(3), 8))


# -- demappers ------------------------------------------------------------------


@pytest.mark.parametrize("kind, order", [*(("qam", o) for o in QAM_ORDERS),
                                         *(("mpsk", o) for o in PSK_ORDERS)])
@pytest.mark.parametrize("n0", [0.02, 0.3, 2.0])
def test_bit_llrs_within_tolerance_of_jax(kind, order, n0):
    k = _bits_per_symbol(kind, order)
    table = _table(kind, order)
    g = np.random.default_rng(order * 7 + int(n0 * 100))
    bits = g.integers(0, 2, (k * 64, 16)).astype(np.int8)
    sym = np.asarray((jax_mod.qam_map if kind == "qam" else jax_mod.mpsk_map)(
        jnp.asarray(bits), table, order))
    y = (sym + np.sqrt(n0 / 2) * g.normal(size=sym.shape)).astype(np.float32)
    port = qam_bit_llrs if kind == "qam" else mpsk_bit_llrs
    ref = jax_demap.qam_bit_llrs if kind == "qam" else jax_demap.mpsk_bit_llrs
    got = port(torch.as_tensor(y), table, order, n0)
    assert got.is_contiguous() and tuple(got.shape) == (k * 64, 16)
    _close_llrs(got, ref(jnp.asarray(y), table, order, n0))


def _brute_force_llrs(y_iq, points, k, n0):
    """Enumerate all 2^k patterns: LLR_p = lse(bit 0) - lse(bit 1), float64."""
    n_sym, batch, _ = y_iq.shape
    out = np.zeros((n_sym, batch, k))
    metric = -((y_iq[:, :, None, :] - points) ** 2).sum(-1) / n0
    for p in range(k):
        bit = (np.arange(1 << k) >> (k - 1 - p)) & 1
        lse = lambda m: np.log(np.exp(m - m.max(-1, keepdims=True)).sum(-1)) + m.max(-1)
        out[..., p] = lse(metric[..., bit == 0]) - lse(metric[..., bit == 1])
    return out.transpose(0, 2, 1).reshape(n_sym * k, batch)


@pytest.mark.parametrize("kind, order", [("qam", 2), ("qam", 4), ("qam", 8), ("mpsk", 4),
                                         ("mpsk", 8)])
def test_llrs_match_brute_force(kind, order):
    k = _bits_per_symbol(kind, order)
    table = _table(kind, order)
    y = np.random.default_rng(order).normal(size=(6, 5, 2)).astype(np.float32)
    v = torch.arange(1 << k, dtype=torch.int64)
    patterns = ((v[None, :] >> torch.arange(k - 1, -1, -1)[:, None]) & 1)  # [k, 2^k]
    mapper = qam_map if kind == "qam" else mpsk_map
    points = mapper(patterns.to(torch.int8), table, order)[0].double().numpy()  # [2^k, 2]
    n0 = 0.37 if kind == "qam" else 0.8
    got = (qam_bit_llrs if kind == "qam" else mpsk_bit_llrs)(torch.as_tensor(y), table, order, n0)
    np.testing.assert_allclose(got.numpy(), _brute_force_llrs(y, points, k, n0),
                               rtol=1e-4, atol=1e-4)


def test_qam4_is_bpsk_per_component():
    table = gray_encoding_table(1)
    y = np.random.default_rng(2).normal(size=(5, 4, 2)).astype(np.float32)
    n0 = 0.5
    llr = qam_bit_llrs(torch.as_tensor(y), table, 2, n0).numpy()
    sign = np.sign(qam_map(torch.zeros((2, 1), dtype=torch.int8), table, 2)[0, 0, 0].item())
    amp = 1 / np.sqrt(2)
    np.testing.assert_allclose(llr[0::2], sign * 4 * amp * y[..., 0] / n0, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(llr[1::2], sign * 4 * amp * y[..., 1] / n0, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kind, order", [("qam", 4), ("qam", 8), ("mpsk", 8), ("mpsk", 16)])
def test_map_demap_roundtrip_high_snr(kind, order):
    k = _bits_per_symbol(kind, order)
    table = _table(kind, order)
    bits = torch.as_tensor(np.random.default_rng(3).integers(0, 2, (12 * k, 7)), dtype=torch.int8)
    y = (qam_map if kind == "qam" else mpsk_map)(bits, table, order)
    llr = (qam_bit_llrs if kind == "qam" else mpsk_bit_llrs)(y, table, order, 1e-3)
    assert torch.equal(llr < 0, bits.bool())


def test_n0_and_ebn0_conventions():
    assert n0_from_sigma2(0.3, 1) == pytest.approx(0.6)
    assert n0_from_sigma2(0.3, 4) == pytest.approx(0.15)
    assert n0_from_sigma2(0.3, 4) == jax_demap.n0_from_sigma2(0.3, 4)
    for db in (-1.0, 0.8, 3.5):
        sigma2 = sigma2_from_ebn0_db(db, 0.5)
        assert ebn0_db_from_sigma2(sigma2, 0.5) == pytest.approx(db)
        assert ebn0_db_from_sigma2(sigma2, 0.5) == jax_awgn.ebn0_db_from_sigma2(sigma2, 0.5)


def test_awgn_transmit_variance():
    x = torch.zeros((20000, 4, 2))
    g = torch.Generator().manual_seed(4)
    y = awgn_transmit(g, x, 0.5, complex_noise=True)
    assert y.dtype == torch.float32
    assert abs(float(y.var()) - 0.25) < 0.01  # sigma^2 / 2 per component
    assert abs(float((y ** 2).sum(-1).mean()) - 0.5) < 0.02  # E|n|^2 = sigma^2
    y = awgn_transmit(g, torch.ones(40000), 0.3)
    assert abs(float(y.mean()) - 1.0) < 0.02 and abs(float(y.var()) - 0.3) < 0.015


# -- the engine's M-ary step ---------------------------------------------------------


def _port_sim(wlan, modulation_, order, batch, **kw):
    layout, enc, _ = wlan
    args = dict(device="cpu", max_iters=5, chain="encoded", llr_source="true",
                modulation=modulation_, mod_order=order, encoder=enc, batch_per_device=batch)
    args.update(kw)
    return BERSimulator(layout, "minsum", **args)


@pytest.mark.parametrize("kind, order, ebn0_db", [("qam", 4, 3.5), ("mpsk", 8, 4.0)])
def test_mary_step_matches_the_jax_composition(wlan, kind, order, ebn0_db):
    """Shared info bits and noise: the port's LLRs within tolerance of the
    JAX engine's composition (encode, map, sym + sqrt(n0/2) noise, demap);
    and the port's decode of the JAX LLRs counts what the JAX engine's
    decode and error count do."""
    layout, _, H = wlan
    batch = 8
    sim = _port_sim(wlan, kind, order, batch, batch_tile=batch)
    jsim = JaxSimulator(
        jax_model("wlan-1296").make_layout(), "minsum", max_iters=5, chain="encoded",
        llr_source="true", modulation=kind, mod_order=order, batch_per_device=batch,
        n_devices=1, encoder=JaxEncoder(H), backend="xla",
    )
    k = _bits_per_symbol(kind, order)
    n_sym = layout.n_vars // k
    g = np.random.default_rng(5)
    info = g.integers(0, 2, (layout.data_len, batch)).astype(np.int8)
    noise = g.normal(size=(2 * n_sym, batch)).astype(np.float32)
    sigma2 = sim.sigma2_for(ebn0_db)

    codeword = jsim._encode_device(jnp.asarray(info))
    table = jsim._encoding_table
    sym = (jax_mod.qam_map if kind == "qam" else jax_mod.mpsk_map)(codeword, table, order)
    n0 = jax_demap.n0_from_sigma2(jnp.float32(sigma2_from_ebn0_db(ebn0_db, 0.5)), k)
    assert sim.n0_for(sigma2) == float(n0)
    y = sym + jnp.sqrt(n0 / 2.0) * jnp.asarray(noise.reshape(n_sym, 2, batch).transpose(0, 2, 1))
    want = (jax_demap.qam_bit_llrs if kind == "qam" else jax_demap.mpsk_bit_llrs)(
        y, table, order, n0)

    port_codeword = sim._encode(torch.as_tensor(info))
    assert np.array_equal(port_codeword.numpy(), np.asarray(codeword))
    _close_llrs(sim.mary_llrs(port_codeword, torch.as_tensor(noise), sigma2), want)

    res = jsim._decode(want, None)
    per_cw = jsim._count_errors(res.outputs, codeword)
    e, f, it = sim.decode_and_count(torch.as_tensor(np.array(want)), port_codeword)
    assert int(e) == int(jnp.sum(per_cw)) > 0
    assert int(f) == int(jnp.sum(per_cw > 0))
    assert float(it) == float(res.iterations)
    own = sim.decode_and_count(sim.mary_llrs(port_codeword, torch.as_tensor(noise), sigma2),
                               port_codeword)
    codeword = sim._encode(torch.as_tensor(info))
    step = sim.decode_and_count(sim.mary_llrs(codeword, torch.as_tensor(noise), sigma2), codeword)
    assert [float(v) for v in step] == [float(v) for v in own]


def test_a_qam16_step_counts_what_its_shards_count(wlan):
    b = 4

    def sim(batch):
        s = _port_sim(wlan, "qam", 4, batch, max_iters=3, batch_tile=4, early_exit=False)
        s._key = rng.key_words(step_seed(0, 3.0, 7))
        return s

    whole, half = sim(2 * b), sim(b)
    sigma2 = whole.sigma2_for(3.0)
    assert whole.quantizer_for(3.0) is None and whole.channel_input_kind is None
    e, f, it = whole._draw_step(None, sigma2)
    parts = [half._draw_step(None, sigma2, offset) for offset in (0, b)]
    assert int(e) == sum(int(p[0]) for p in parts) > 0
    assert int(f) == sum(int(p[1]) for p in parts)
    assert float(it) == 2.0 and all(float(p[2]) == 2.0 for p in parts)


def test_the_mary_draw_is_a_normal_plane_on_stream_1(wlan):
    """The noise a step demaps is the Philox normal plane of 2 n_vars / k rows
    (``rng.plane_plain``), drawn after the info-bit plane."""
    layout = wlan[0]
    sim = _port_sim(wlan, "mpsk", 8, 3, max_iters=2)
    sim._key = rng.key_words(step_seed(0, 4.0, 2))
    sigma2 = sim.sigma2_for(4.0)
    info = rng.plane_plain("bits", sim._key, layout.data_len, 0, 3)
    noise = rng.plane_plain("normal", sim._key, 2 * layout.n_vars // 3, 0, 3)
    codeword = sim._encode(info)
    want = [float(v) for v in sim.decode_and_count(sim.mary_llrs(codeword, noise, sigma2),
                                                   codeword)]
    assert [float(v) for v in sim._draw_step(None, sigma2)] == want
    with pytest.raises(ValueError, match="unknown channel input"):
        rng.channel_input(sim.channel_input_kind, sim._key, 10, 0, 3, "cpu", None)


def test_qam16_point_at_6db_and_the_guards(wlan):
    """tests/test_demap.py's QAM-16 point: min-sum at 6 dB decodes nearly
    clean; the JAX engine's guards raise ValueError."""
    layout, enc, _ = wlan
    sim = _port_sim(wlan, "qam", 4, 32, max_iters=20, seed=5)
    res = sim.run_point(6.0, min_errors=1, max_blocks=32)
    assert res.blocks == 32 and res.ber < 1e-3
    with pytest.raises(ValueError, match="float decoder"):
        BERSimulator(layout, "ib", device="cpu", trellis=None, max_iters=5, modulation="qam",
                     mod_order=4, chain="encoded", llr_source="true", encoder=enc)
    with pytest.raises(ValueError, match="encoded chain"):
        BERSimulator(layout, "minsum", device="cpu", max_iters=5, modulation="qam", mod_order=4,
                     chain="allzero", llr_source="true")
    with pytest.raises(ValueError, match="not divisible by 5"):
        BERSimulator(layout, "minsum", device="cpu", max_iters=5, modulation="mpsk",
                     mod_order=32, chain="encoded", llr_source="true", encoder=enc)
    with pytest.raises(ValueError, match="unknown modulation"):
        BERSimulator(layout, "minsum", device="cpu", max_iters=5, modulation="ask")
