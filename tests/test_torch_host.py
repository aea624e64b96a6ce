"""The port's own copies of the JAX package's numpy host code.

The port imports nothing of the JAX package, so it carries its own
``codes`` (check matrices, Tanner graphs), ``ib`` quantizer, host GF(2)
encoder and model zoo. Each copy must give exactly what the JAX package's
module gives: equal check matrices (sparsity and entries), equal graph
arrays, equal model settings, equal quantizers, and encoders equal bit for
bit.
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp

from informationbottleneckdecodingldpc_tpu import codes as jax_codes
from informationbottleneckdecodingldpc_tpu.encode import encoder as jax_encoder
from informationbottleneckdecodingldpc_tpu.ib import (
    optimal_symmetric_quantizer as jax_quantizer,
)
from informationbottleneckdecodingldpc_tpu.models import zoo as jax_zoo
from informationbottleneckdecodingldpc_torch import codes
from informationbottleneckdecodingldpc_torch.encode import encoder
from informationbottleneckdecodingldpc_torch.ib import optimal_symmetric_quantizer
from informationbottleneckdecodingldpc_torch.models import zoo

CHECK_MATRICES = [
    ("wlan-1296", lambda c: zoo.get_model("wlan-1296").make_h(), lambda c: jax_zoo.get_model("wlan-1296").make_h()),
    ("dvbs2-64800", lambda c: zoo.get_model("dvbs2-64800").make_h(), lambda c: jax_zoo.get_model("dvbs2-64800").make_h()),
    ("regular-3-6-8000", lambda c: zoo.get_model("regular-3-6-8000").make_h(), lambda c: jax_zoo.get_model("regular-3-6-8000").make_h()),
    ("regular-3-6-504", lambda c: zoo.get_model("regular-3-6-504").make_h(), lambda c: jax_zoo.get_model("regular-3-6-504").make_h()),
    ("qc96", lambda c: c.regular_qc_parity_check(96, 3, 6, seed=7), lambda c: c.regular_qc_parity_check(96, 3, 6, seed=7)),
]


def _same(a, b) -> bool:
    """Equal values, recursively through dataclasses, sequences and arrays."""
    if dataclasses.is_dataclass(a):
        return type(a).__name__ == type(b).__name__ and all(
            _same(getattr(a, f.name), getattr(b, f.name)) for f in dataclasses.fields(a)
        )
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and np.array_equal(a, b)
    return a == b


def _equal_h(got: sp.spmatrix, want: sp.spmatrix) -> bool:
    got, want = sp.csr_matrix(got), sp.csr_matrix(want)
    return (
        got.shape == want.shape
        and np.array_equal(got.indptr, want.indptr)
        and np.array_equal(got.indices, want.indices)
        and np.array_equal(got.data, want.data)
    )


@pytest.mark.parametrize("name, port_h, jax_h", CHECK_MATRICES, ids=[c[0] for c in CHECK_MATRICES])
def test_check_matrix_and_graph_equal_jax(name, port_h, jax_h):
    H = port_h(codes)
    want = jax_h(jax_codes)
    assert _equal_h(H, want)
    assert _same(codes.TannerGraph.from_check_matrix(H), jax_codes.TannerGraph.from_check_matrix(want))


def test_model_settings_equal_jax():
    assert set(zoo.MODELS) == set(jax_zoo.MODELS)
    skip = {"make_h", "layout_keys", "layout_edge_keys"}
    for name, spec in zoo.MODELS.items():
        ref = jax_zoo.MODELS[name]
        for f in dataclasses.fields(ref):
            if f.name in skip:
                assert (getattr(spec, f.name) is None) == (getattr(ref, f.name) is None)
            else:
                assert getattr(spec, f.name) == getattr(ref, f.name), (name, f.name)
    keys, want = zoo.get_model("dvbs2-64800").layout_keys(), jax_zoo.get_model("dvbs2-64800").layout_keys()
    assert _same(list(keys), list(want))
    with pytest.raises(KeyError):
        zoo.get_model("no-such-code")


def test_dvbs2_layout_edge_keys_equal_jax():
    H = codes.dvbs2_like_parity_check(6480, 3240, seed=2)
    assert _same(list(codes.dvbs2_layout_edge_keys(H, 3240)), list(jax_codes.dvbs2_layout_edge_keys(H, 3240)))


@pytest.mark.parametrize("seed, k", [(0, 4), (1, 16), (2, 32)])
def test_optimal_symmetric_quantizer_equals_jax(seed, k):
    rng = np.random.default_rng(seed)
    p0 = rng.random(400) * np.linspace(0.1, 2.0, 400)
    p_xy = 0.5 * np.stack([p0, p0[::-1]], axis=1)
    p_xy /= p_xy.sum()
    assert _same(optimal_symmetric_quantizer(p_xy, k), jax_quantizer(p_xy, k))


@pytest.mark.parametrize("code", ["wlan", "dvbs2_like"])
def test_host_encoder_equals_jax(code):
    if code == "wlan":
        H = codes.wlan_80211n_parity_check()
    else:
        H = codes.dvbs2_like_parity_check(6480, 3240, seed=2)
    port, ref = encoder.LDPCEncoder(H), jax_encoder.LDPCEncoder(H)
    assert (port.method, port.is_staircase) == (ref.method, ref.is_staircase)
    assert _same(port.row_order, ref.row_order)
    info = np.random.default_rng(3).integers(0, 2, (port.k, 70)).astype(np.int8)
    cw = port.encode(info)
    assert cw.dtype == np.int8 and np.array_equal(cw, ref.encode(info))
    assert not port.check(cw).any()


@pytest.mark.parametrize("code", ["wlan", "dvbs2_like"])
def test_host_syndrome_of_noisy_words_equals_jax(code):
    if code == "wlan":
        H = codes.wlan_80211n_parity_check()
    else:
        H = codes.dvbs2_like_parity_check(6480, 3240, seed=2)
    port, ref = encoder.LDPCEncoder(H), jax_encoder.LDPCEncoder(H)
    rng = np.random.default_rng(4)
    cw = port.encode(rng.integers(0, 2, (port.k, 67)).astype(np.int8))
    cw ^= (rng.random(cw.shape) < 0.01).astype(np.int8)  # flip about 1% of the bits
    got = port.check(cw)
    assert got.any() and np.array_equal(got, ref.check(cw))


def test_gf2_dense_inverse_equals_jax():
    rng = np.random.default_rng(5)
    B = np.triu(rng.integers(0, 2, (40, 40)), 1).astype(np.uint8)
    B[np.arange(40), np.arange(40)] = 1
    B = B[rng.permutation(40)]
    inv = encoder._gf2_dense_inverse(B)
    assert np.array_equal(inv, jax_encoder._gf2_dense_inverse(B))
    assert np.array_equal((inv.astype(int) @ B) % 2, np.eye(40, dtype=int))
    assert encoder._gf2_dense_inverse(np.zeros((3, 3), np.uint8)) is None
