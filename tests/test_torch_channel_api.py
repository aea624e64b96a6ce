"""The port's last public API against the JAX package: the quantizer class,
the keyed samplers, ``make_fused_ib_decoder`` and the three decode factories.

Inputs are made with numpy from a seed and fed to both sides. The class's
tables, ``quantize`` and ``quantize_llr`` equal the JAX class's (``==``). The
keyed samplers draw Philox uniforms (``sim/rng.py``), not JAX's threefry
bits, so their draws equal the JAX ``*_from_uniform`` functions over the
port's ``plane_plain`` uniforms, and their distribution is held to the
tables as the JAX test of its sampler does (``tests/test_channel.py``). The
factories run on the 96-variable QC code of ``tests/test_torch_ib_lut.py``:
IB and min-sum ``==``, BP within 1e-5 of max(1, |ref|).
"""

import dataclasses
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from informationbottleneckdecodingldpc_tpu.channel import quantizer as jax_quant
from informationbottleneckdecodingldpc_tpu.codes import TannerGraph
from informationbottleneckdecodingldpc_tpu.codes.random_codes import regular_qc_parity_check
from informationbottleneckdecodingldpc_tpu.construct import build_decoder_config
from informationbottleneckdecodingldpc_tpu.decode import DecodeLayout as JaxLayout
from informationbottleneckdecodingldpc_tpu.decode import DeviceTrellis as JaxTrellis
from informationbottleneckdecodingldpc_tpu.decode import jit as jax_factories
from informationbottleneckdecodingldpc_tpu.kernels import (
    make_fused_ib_decoder as jax_make_fused_ib_decoder,
)
from informationbottleneckdecodingldpc_torch.channel import (
    AWGNChannelQuantizer,
    sample_clusters_with,
    sample_llrs_with,
)
from informationbottleneckdecodingldpc_torch.construct import TrellisTables
from informationbottleneckdecodingldpc_torch.decode import (
    DecodeLayout,
    DeviceTrellis,
    make_bp_decoder,
    make_ib_lut_decoder,
    make_min_sum_decoder,
)
from informationbottleneckdecodingldpc_torch.kernels import FusedIBDecoder, make_fused_ib_decoder
from informationbottleneckdecodingldpc_torch.sim import rng

BP_RTOL = 1e-5
TABLE_FIELDS = ("sigma2", "ad_max_abs", "cardinality_t", "cardinality_y", "limits",
                "cdf_t_given_x0", "output_llrs", "p_x_and_t", "mi_xt", "mi_xy")


@pytest.mark.parametrize("sigma2", [0.5, 0.8])
@pytest.mark.parametrize("cardinality_t", [8, 16, 32])
def test_quantizer_class_matches_jax(sigma2, cardinality_t):
    q = AWGNChannelQuantizer(sigma2, 3.0, cardinality_t, 2000, device="cpu")
    jq = jax_quant.AWGNChannelQuantizer(sigma2, 3.0, cardinality_t, 2000)
    for f in TABLE_FIELDS:
        assert np.array_equal(getattr(q.tables, f), getattr(jq.tables, f)), f
    assert q.cardinality_t == jq.cardinality_t == cardinality_t
    assert q.device == torch.device("cpu")
    for f in ("limits", "cdf", "llrs"):
        assert np.array_equal(getattr(q.device_tables, f).numpy(), np.asarray(getattr(jq.device, f)))
    y = np.random.default_rng(cardinality_t).normal(1.0, np.sqrt(sigma2), (64, 50)).astype(np.float32)
    y[0, :5] = [0.0, -3.5, 3.5, q.tables.limits[1], q.tables.limits[-1]]  # borders and clips
    clusters = q.quantize(torch.as_tensor(y))
    assert clusters.dtype == torch.int32
    assert np.array_equal(clusters.numpy(), np.asarray(jq.quantize(jnp.asarray(y))))
    assert np.array_equal(q.quantize_llr(torch.as_tensor(y)).numpy(),
                          np.asarray(jq.quantize_llr(jnp.asarray(y))))


@pytest.mark.parametrize("shape", [(96, 33), (200,), (3, 4, 5)])
def test_keyed_samplers_equal_the_jax_functions_over_philox_uniforms(shape):
    q = AWGNChannelQuantizer(0.8, 3.0, 16, 2000, device="cpu")
    jt = jax_quant.device_tables(jax_quant.build_quantizer_tables(0.8, 3.0, 16, 2000))
    key = rng.key_words(0x0123456789ABCDEF)
    bits = np.random.default_rng(len(shape)).integers(0, 2, shape).astype(np.int32)
    # A 2-D shape is [rows, batch]; any other is one [1, numel] plane.
    rows, batch = shape if len(shape) == 2 else (1, bits.size)
    u = rng.plane_plain("uniform", key, rows, 0, batch).reshape(shape).numpy()
    clusters = q.sample_clusters(key, torch.as_tensor(bits))
    assert clusters.shape == shape and clusters.dtype == torch.int32
    want = jax_quant.sample_clusters_from_uniform(jt.cdf, jnp.asarray(u), jnp.asarray(bits))
    assert np.array_equal(clusters.numpy(), np.asarray(want))
    llrs = q.sample_llrs(key, torch.as_tensor(bits))
    want = jax_quant.sample_llrs_from_uniform(jt.cdf, jt.llrs, jnp.asarray(u), jnp.asarray(bits))
    assert llrs.dtype == torch.float32 and np.array_equal(llrs.numpy(), np.asarray(want))
    # The functions the class binds give the same draws.
    t = q.device_tables
    assert torch.equal(sample_clusters_with(t.cdf, key, torch.as_tensor(bits)), clusters)
    assert torch.equal(sample_llrs_with(t.cdf, t.llrs, key, torch.as_tensor(bits)), llrs)


def test_keyed_sampler_refuses_codewords_beyond_the_counter():
    q = AWGNChannelQuantizer(0.8, 3.0, 8, 1000, device="cpu")
    bits = torch.zeros((1, 1), dtype=torch.int32).expand(1, 2**32 + 1)
    with pytest.raises(ValueError, match="below 2\\^32"):
        q.sample_clusters(rng.key_words(1), bits)


def test_direct_sampling_distribution():
    """``tests/test_channel.py``'s test of the JAX sampler, on Philox draws."""
    q = AWGNChannelQuantizer(0.8, 3.0, 8, 1000, device="cpu")
    key = rng.key_words(42)
    n = 200_000
    t = q.sample_clusters(key, torch.zeros((n,), dtype=torch.int32)).numpy()
    emp = np.bincount(t, minlength=8) / n
    expect = np.diff(q.tables.cdf_t_given_x0)
    np.testing.assert_allclose(emp, expect, atol=5e-3)
    # Mirroring: bit 1 distribution is the reverse.
    t1 = q.sample_clusters(key, torch.ones((n,), dtype=torch.int32)).numpy()
    emp1 = np.bincount(t1, minlength=8) / n
    np.testing.assert_allclose(emp1, expect[::-1], atol=5e-3)


def test_quantizer_class_defaults_to_the_card():
    assert inspect.signature(AWGNChannelQuantizer).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            AWGNChannelQuantizer(0.8)


@pytest.fixture(scope="module")
def qc96():
    g = TannerGraph.from_check_matrix(regular_qc_parity_check(96, 3, 6, seed=7))
    cfg = build_decoder_config(design_ebn0_db=2.0, cardinality_y_channel=400,
                               cardinality_t_channel=16, cardinality_t_decoder=16, i_max=6,
                               d_v=3, d_c=6)
    tables = TrellisTables(**dataclasses.asdict(cfg.tables))
    return DecodeLayout.from_graph(g), JaxLayout.from_graph(g), tables, cfg.tables


def _clusters(layout, batch, ebn0_sigma2=0.6, seed=0):
    """Channel clusters of the all-zeros codeword, sampled from numpy uniforms."""
    t = jax_quant.device_tables(jax_quant.build_quantizer_tables(ebn0_sigma2, 3.0, 16, 400))
    u = np.random.default_rng(seed).random((layout.n_vars, batch), dtype=np.float32)
    zeros = np.zeros(u.shape, np.int32)
    return np.array(jax_quant.sample_clusters_from_uniform(t.cdf, jnp.asarray(u), jnp.asarray(zeros)))


def _same(got, want, outputs_close=None):
    if outputs_close is None:
        assert np.array_equal(got.outputs.numpy(), np.asarray(want.outputs))
    else:
        outputs_close(got.outputs.numpy(), np.asarray(want.outputs))
    assert np.array_equal(got.unsatisfied.numpy(), np.asarray(want.unsatisfied))
    assert float(got.iterations) == float(want.iterations)


def test_make_fused_ib_decoder_matches_jax(qc96):
    layout, jlayout, tables, jtables = qc96
    ch = _clusters(layout, 16)
    dec = make_fused_ib_decoder(layout, tables, early_exit=True, batch_tile=8)
    assert isinstance(dec, FusedIBDecoder) and dec.batch_tile == 8
    want = jax_make_fused_ib_decoder(jlayout, jtables, early_exit=True, batch_tile=8,
                                     interpret=True)(jnp.asarray(ch))
    _same(dec(torch.as_tensor(ch)), want)
    assert dec.launches == 0  # the CPU twin launches no kernel


def _llrs(layout, batch, seed):
    """Consistent Gaussian channel LLRs N(4, 8) (the tiles exit on their own)."""
    g = np.random.default_rng(seed)
    return g.normal(4.0, np.sqrt(8.0), (layout.n_vars, batch)).astype(np.float32)


def _close_bp(got, want):
    assert np.all(np.abs(got - want) <= BP_RTOL * np.maximum(1.0, np.abs(want)))


@pytest.mark.parametrize("decoder", ["ib", "minsum", "bp"])
@pytest.mark.parametrize("early_exit", [True, False])
def test_decode_factories_match_jax(qc96, decoder, early_exit):
    layout, jlayout, tables, jtables = qc96
    if decoder == "ib":
        x = _clusters(layout, 16, seed=3)
        dec = make_ib_lut_decoder(layout, DeviceTrellis.from_tables(tables, "cpu"),
                                  max_iters=5, early_exit=early_exit)
        jdec = jax_factories.make_ib_lut_decoder(jlayout, JaxTrellis.from_tables(jtables),
                                                 max_iters=5, early_exit=early_exit)
    else:
        x = _llrs(layout, 16, seed=4)
        make, jmake = {"minsum": (make_min_sum_decoder, jax_factories.make_min_sum_decoder),
                       "bp": (make_bp_decoder, jax_factories.make_bp_decoder)}[decoder]
        dec, jdec = (m(lay, 12, early_exit=early_exit) for m, lay in ((make, layout), (jmake, jlayout)))
    _same(dec(torch.as_tensor(x)), jdec(jnp.asarray(x)), _close_bp if decoder == "bp" else None)
