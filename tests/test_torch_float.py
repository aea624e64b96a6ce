"""The PyTorch port's float decoders and fused-kernel twin against the JAX
package.

Inputs are made with numpy from a seed and fed to both sides. Min-sum, the
sums and the clamps use only exact operations, so they are compared with
``==`` (which treats +0 and -0 as equal: the min1/min2 form and the pairwise
form may give zeros of different sign). Box-plus goes through exp and
log1p, whose last bits differ between XLA and torch: one box-plus stays
within one float32 ULP of max(|value|, 1), measured at exactly one ULP for
|a|, |b| up to 15; a BP decode stays within ``BP_RTOL`` * max(1, |ref|),
measured at 1.2e-6 after 5 iterations on WLAN. The twin of the CUDA kernel
K2 compares with the JAX Pallas kernel in interpret mode on the 96-variable
QC code of tests/test_float_fused.py.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax.experimental.compilation_cache import compilation_cache

from informationbottleneckdecodingldpc_tpu.channel import quantizer as jax_quant
from informationbottleneckdecodingldpc_tpu.codes import TannerGraph
from informationbottleneckdecodingldpc_tpu.codes.random_codes import (
    regular_qc_parity_check,
)
from informationbottleneckdecodingldpc_tpu.decode import (
    DecodeLayout as JaxLayout,
    belief_propagation_decode as jax_bp_decode,
    min_sum_decode as jax_min_sum_decode,
)
from informationbottleneckdecodingldpc_tpu.kernels.float_fused import (
    FusedFloatDecoder as JaxFusedFloatDecoder,
)
from informationbottleneckdecodingldpc_tpu.models import get_model as jax_model
from informationbottleneckdecodingldpc_tpu.ops import float_ops as jax_ops
from informationbottleneckdecodingldpc_torch.channel import (
    build_quantizer_tables,
    device_tables,
    quantize_llr_with,
    sample_llrs_from_uniform,
    sigma2_from_ebn0_db,
)
from informationbottleneckdecodingldpc_torch.decode import (
    DecodeLayout,
    belief_propagation_decode,
    float_decode,
    min_sum_decode,
)
from informationbottleneckdecodingldpc_torch.kernels import (
    FusedFloatDecoder,
    pick_float_batch_tile,
)
from informationbottleneckdecodingldpc_torch.kernels.float_fused import shared_bytes
from informationbottleneckdecodingldpc_torch.models import get_model
from informationbottleneckdecodingldpc_torch.ops import float_ops

BP_RTOL = 1e-5
MEAN = 4.0  # LLR mean of the twin cases: tiles of 8 exit after different bodies


@pytest.fixture(scope="module")
def wlan():
    return get_model("wlan-1296").make_layout(), jax_model("wlan-1296").make_layout()


@pytest.fixture(scope="module")
def qc96():
    g = TannerGraph.from_check_matrix(regular_qc_parity_check(96, 3, 6, seed=7))
    return DecodeLayout.from_graph(g), JaxLayout.from_graph(g)


def _equal(got: torch.Tensor, want) -> bool:
    """Equal as float values: +0 == -0."""
    want = np.asarray(want)
    return got.shape == want.shape and bool(np.all(got.numpy() == want))


def _close_bp(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    err = np.abs(got.numpy() - want)
    assert np.all(err <= BP_RTOL * np.maximum(1.0, np.abs(want))), err.max()


def _quantized_llrs(ebn0_db, shape, seed, rate=0.5):
    """LLRs sampled on both sides from one numpy uniform plane (all-zeros
    codeword); the two must agree exactly."""
    sigma2 = sigma2_from_ebn0_db(ebn0_db, rate)
    qt = device_tables(build_quantizer_tables(sigma2, 3.0, 16, 2000), "cpu")
    jqt = jax_quant.device_tables(jax_quant.build_quantizer_tables(sigma2, 3.0, 16, 2000))
    u = np.random.default_rng(seed).random(shape, dtype=np.float32)
    got = sample_llrs_from_uniform(
        qt.cdf, qt.llrs, torch.as_tensor(u), torch.zeros(shape, dtype=torch.int32)
    )
    want = jax_quant.sample_llrs_from_uniform(
        jqt.cdf, jqt.llrs, jnp.asarray(u), jnp.zeros(shape, jnp.int32)
    )
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), np.asarray(want))
    return got


# -- float_ops ---------------------------------------------------------------

def _planes(seed, d, n=12, batch=16):
    rng = np.random.default_rng(seed)
    msgs = rng.normal(0.0, 4.0, (d, n, batch)).astype(np.float32)
    # Ties at the smallest magnitude, exact zeros and clamp-range values.
    msgs[:, 0, 0] = 1.5
    msgs[0, 1, :2] = 0.0
    msgs[-1, 2, :] = -0.0
    msgs[:, 3, 1] = -2.0
    msgs[0, 4, :] = 200.0
    return msgs


@pytest.mark.parametrize("d", [2, 3, 7, 11])
def test_exact_float_ops_match_jax(d):
    msgs = _planes(d, d)
    ch = np.random.default_rng(100 + d).normal(1.0, 3.0, msgs.shape[1:]).astype(np.float32)
    t, j = torch.as_tensor(msgs), jnp.asarray(msgs)
    pairs = [
        (float_ops.min_sum_op(t[0], t[-1]), jax_ops.min_sum_op(j[0], j[-1])),
        (float_ops.cn_minsum_leave_one_out(t), jax_ops.cn_minsum_leave_one_out(j)),
        (
            torch.stack(float_ops.minsum_leave_one_out_planes(list(t))),
            jnp.stack(jax_ops.minsum_leave_one_out_planes(list(j))),
        ),
        (
            torch.stack(float_ops.minsum_leave_one_out_planes(list(t))),
            jax_ops.cn_minsum_leave_one_out(j),  # min1/min2 == pairwise
        ),
        (float_ops.sum_planes(t), jax_ops.sum_planes(j)),
        (
            float_ops.vn_sum_leave_one_out(torch.as_tensor(ch), t),
            jax_ops.vn_sum_leave_one_out(jnp.asarray(ch), j),
        ),
        (
            float_ops.vn_sum_leave_one_out(torch.as_tensor(ch), t[:1]),
            jax_ops.vn_sum_leave_one_out(jnp.asarray(ch), j[:1]),
        ),
    ]
    for got, want in pairs:
        assert _equal(got, want)


def test_minsum_edge_cases_match_jax():
    # The cases of tests/test_float_fused.py: ties, one or two zeros, all
    # equal, degree 2; both forms against the JAX pairwise fold.
    cases = [
        [1.5, -1.5, 2.0, 1.5, -3.0],
        [0.0, 2.0, -1.0, 4.0],
        [0.0, -0.0, 3.0],
        [-2.0, -2.0, -2.0, -2.0],
        [5.0, -1.0],
    ]
    for vals in cases:
        planes = np.stack([np.full((4, 8), v, np.float32) for v in vals])
        want = jax_ops.associative_leave_one_out(jax_ops.min_sum_op, jnp.asarray(planes))
        t = torch.as_tensor(planes)
        assert _equal(torch.stack(float_ops.minsum_leave_one_out_planes(list(t))), want)
        assert _equal(float_ops.associative_leave_one_out(float_ops.min_sum_op, t), want)


@contextlib.contextmanager
def _compiled_here():
    """Compile in this process, for this host, without the persistent
    compilation cache (tests/conftest.py): its CPU key names the platform
    'cpu' and no CPU features, so an entry left by another host is loaded as
    it stands, and XLA's exp/log1p bits depend on the ISA it compiled for."""
    enabled = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    compilation_cache.reset_cache()
    try:
        yield
    finally:
        jax.config.update("jax_enable_compilation_cache", enabled)
        compilation_cache.reset_cache()


def test_boxplus_within_one_ulp_of_jax():
    rng = np.random.default_rng(7)
    a = rng.uniform(-15, 15, (256, 128)).astype(np.float32)
    b = rng.uniform(-15, 15, (256, 128)).astype(np.float32)
    a[0, :8] = [0.0, -0.0, 1.5, -1.5, 150.0, -150.0, 1e-3, 3.0]
    b[0, :8] = [0.0, 0.0, 1.5, 1.5, -150.0, 150.0, -1e-3, -3.0]
    got = float_ops.boxplus(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    with _compiled_here():
        want = np.asarray(jax.jit(jax_ops.boxplus)(jnp.asarray(a), jnp.asarray(b)))
    ulp = np.spacing(np.maximum(np.abs(want), np.float32(1.0)))
    assert np.all(np.abs(got - want) <= ulp)


@pytest.mark.parametrize("d", [3, 8])
def test_boxplus_leave_one_out_matches_jax(d):
    msgs = _planes(10 + d, d)
    got = float_ops.cn_boxplus_leave_one_out(torch.as_tensor(msgs))
    want = jax_ops.cn_boxplus_leave_one_out(jnp.asarray(msgs))
    _close_bp(got, want)


def test_leave_one_out_rejects_degree_one():
    one = [torch.zeros(2, 2)]
    with pytest.raises(ValueError):
        float_ops.cn_minsum_leave_one_out(torch.zeros(1, 2, 2))
    with pytest.raises(ValueError):
        float_ops.minsum_leave_one_out_planes(one)


def test_quantize_llr_with_matches_jax():
    y = np.random.default_rng(5).normal(1.0, 0.8, (96, 6)).astype(np.float32)
    y[0, :3] = [0.0, -3.5, 3.5]
    tables = build_quantizer_tables(0.5, 3.0, 16, 400)
    qt = device_tables(tables, "cpu")
    jqt = jax_quant.device_tables(jax_quant.build_quantizer_tables(0.5, 3.0, 16, 400))
    got = quantize_llr_with(qt.limits, qt.llrs, torch.as_tensor(y))
    want = jax_quant.quantize_llr_with(jqt.limits, jqt.llrs, jnp.asarray(y))
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), np.asarray(want))


# -- whole-batch decoders on WLAN ---------------------------------------------

@pytest.mark.parametrize("max_iters, early_exit", [(5, False), (50, True)])
def test_wlan_min_sum_decode_matches_jax(wlan, max_iters, early_exit):
    layout, jlayout = wlan
    llrs = _quantized_llrs(2.0, (layout.n_vars, 8), seed=1)
    got = min_sum_decode(layout, llrs, max_iters, early_exit=early_exit)
    want = jax_min_sum_decode(
        jlayout, jnp.asarray(llrs.numpy()), max_iters=max_iters, early_exit=early_exit
    )
    assert _equal(got.outputs, want.outputs)
    assert np.array_equal(got.unsatisfied.numpy(), np.asarray(want.unsatisfied))
    assert int(got.iterations) == int(want.iterations)
    if early_exit:
        assert int(got.iterations) < max_iters - 1  # early exit fired


def test_wlan_bp_decode_matches_jax_within_tolerance(wlan):
    layout, jlayout = wlan
    llrs = _quantized_llrs(2.0, (layout.n_vars, 8), seed=0)
    got = belief_propagation_decode(layout, llrs, 5, early_exit=False)
    want = jax_bp_decode(jlayout, jnp.asarray(llrs.numpy()), max_iters=5, early_exit=False)
    _close_bp(got.outputs, want.outputs)
    ref = np.asarray(want.outputs)
    sure = np.abs(ref) > 1e-3
    assert np.array_equal((got.outputs.numpy() < 0)[sure], (ref < 0)[sure])
    assert np.array_equal(got.unsatisfied.numpy(), np.asarray(want.unsatisfied))
    assert int(got.iterations) == int(want.iterations) == 4


# -- K2's plain twin against the JAX Pallas kernel (interpret mode) -----------

def _normal_llrs(seed, n, batch, mean):
    """Consistent Gaussian channel LLRs, N(mean, 2 mean)."""
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.normal(mean, np.sqrt(2 * mean), (n, batch)).astype(np.float32))


@pytest.mark.parametrize(
    "rule, batch, tile, max_iters, quantized",
    [
        ("minsum", 24, 8, 12, False),  # three tiles exit on their own
        ("minsum", 24, 8, 12, True),  # discrete LLRs: exact zeros occur
        ("bp", 24, 8, 12, False),
        ("minsum", 16, 16, 12, False),  # one tile: whole-batch lockstep
        ("bp", 16, 16, 12, False),
        ("minsum", 8, 8, 1, False),  # no body: seeded syndrome, zero B
        ("bp", 8, 8, 1, False),
    ],
)
def test_fused_float_twin_matches_jax_kernel(qc96, rule, batch, tile, max_iters, quantized):
    layout, jlayout = qc96
    if quantized:
        # Small integer LLRs: sums cancel to exactly 0.0 (degree-3 nodes
        # rarely cancel the 16 quantizer levels).
        rng = np.random.default_rng(batch)
        llrs = torch.as_tensor(rng.integers(-2, 5, (layout.n_vars, batch)).astype(np.float32))
    else:
        llrs = _normal_llrs(batch + max_iters, layout.n_vars, batch, mean=MEAN)
    dec = FusedFloatDecoder(layout, rule, max_iters=max_iters, batch_tile=tile)
    got = dec(llrs)
    want = JaxFusedFloatDecoder(
        jlayout, rule, max_iters=max_iters, early_exit=True, batch_tile=tile,
        interpret=True,
    )(jnp.asarray(llrs.numpy()))
    if rule == "minsum":
        assert _equal(got.outputs, want.outputs)
    else:
        _close_bp(got.outputs, want.outputs)
    assert np.array_equal(got.unsatisfied.numpy(), np.asarray(want.unsatisfied))
    assert float(got.iterations) == float(want.iterations)
    assert dec.launches == 0  # the CPU twin launches nothing
    if batch == 24 and not quantized:
        assert float(got.iterations) < max_iters - 1  # tiles exit early
    if quantized:
        # The case is there for the zeros: check-node inputs that cancel to
        # exactly 0.0 and zero the other outputs of their check.
        zeros = []

        def spy(msgs, grp):
            zeros.append(int((msgs == 0).sum()))
            return float_ops.cn_minsum_leave_one_out(msgs)

        float_decode(layout, llrs, max_iters, spy)
        assert sum(zeros) > 0


def test_float_batch_tile_fits_shared_memory(wlan, qc96):
    layout = wlan[0]
    assert shared_bytes(layout, 1) == 4 + (2 * 4644 + 1296) * 4
    assert pick_float_batch_tile(layout) == 5
    assert shared_bytes(layout, 5) <= 232_448 < shared_bytes(layout, 6)
    assert pick_float_batch_tile(qc96[0]) == 32
    # A tile that does not fit runs on the CPU twin and is refused before
    # any launch (a meta tensor stands in for a CUDA one).
    with pytest.raises(ValueError, match="shared memory"):
        FusedFloatDecoder(layout, "bp", batch_tile=6)._launch(
            torch.zeros((layout.n_vars, 6), device="meta")
        )
    with pytest.raises(ValueError, match="rule"):
        FusedFloatDecoder(layout, "sum-product")


def test_fused_float_decoder_takes_cuda_or_cpu_only(qc96):
    dec = FusedFloatDecoder(qc96[0], "minsum", max_iters=3)
    with pytest.raises(ValueError, match="no kernel"):
        dec(torch.zeros((qc96[0].n_vars, 4), device="meta"))
