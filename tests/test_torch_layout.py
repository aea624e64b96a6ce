"""The PyTorch port's decode layout against the JAX package's DecodeLayout.

Same Tanner graph into both: the port's plain index arrays must equal the
``perm`` of each JAX permutation plan, and the degree groups must match.
"""

import dataclasses

import numpy as np
import pytest
import torch

from informationbottleneckdecodingldpc_tpu.codes import TannerGraph
from informationbottleneckdecodingldpc_tpu.codes.random_codes import (
    regular_qc_parity_check,
)
from informationbottleneckdecodingldpc_tpu.decode import DecodeLayout as JaxLayout
from informationbottleneckdecodingldpc_tpu.models import get_model as jax_model
from informationbottleneckdecodingldpc_torch.decode import DecodeLayout
from informationbottleneckdecodingldpc_torch.kernels.ib_lut_fused import (
    MAX_SHARED_BYTES,
    pick_batch_tile,
    shared_bytes,
)
from informationbottleneckdecodingldpc_torch.models import get_model


def _layouts(name):
    if name == "qc-96":
        g = TannerGraph.from_check_matrix(regular_qc_parity_check(96, 3, 6, seed=7))
        return DecodeLayout.from_graph(g), JaxLayout.from_graph(g)
    return get_model(name).make_layout(), jax_model(name).make_layout()


@pytest.fixture(scope="module", params=["wlan-1296", "regular-3-6-504", "qc-96"])
def layouts(request):
    return _layouts(request.param)


def test_permutations_equal_jax_plans(layouts):
    port, ref = layouts
    pairs = [
        (port.to_vn_perm, ref.to_vn.perm),
        (port.to_cn_perm, ref.to_cn.perm),
        (port.cn_edge_var, ref.seed_plan.perm),
        (port.vn_node_order, ref.vn_gather_plan.perm),
        (port.vn_node_unperm, ref.vn_unperm_plan.perm),
    ]
    for got, want in pairs:
        assert got.dtype == np.int32
        assert np.array_equal(got, np.asarray(want))


def test_group_specs_equal_jax(layouts):
    port, ref = layouts
    for attr in ("n_vars", "n_checks", "n_edges", "d_c_max", "d_v_max", "data_len"):
        assert getattr(port, attr) == getattr(ref, attr)
    assert port.code_rate == ref.code_rate
    for mine, theirs in (
        (port.cn_groups, ref.cn_groups),
        (port.vn_groups, ref.vn_groups),
    ):
        assert len(mine) == len(theirs)
        for a, b in zip(mine, theirs):
            assert (a.degree, a.offset, a.num_nodes) == (b.degree, b.offset, b.num_nodes)
            assert np.array_equal(a.node_ids, np.asarray(b.node_ids))


def test_route_arrays_invert_the_permutations(layouts):
    port, _ = layouts
    n = port.n_edges
    assert np.array_equal(port.to_vn_perm[port.cn_to_vn_row], np.arange(n))
    assert np.array_equal(port.to_cn_perm[port.vn_to_cn_row], np.arange(n))
    # vn_node_unperm inverts the node gather.
    assert np.array_equal(
        port.vn_node_order[port.vn_node_unperm], np.arange(port.n_vars)
    )


def test_tensors_are_cached_int64(layouts):
    port, _ = layouts
    t = port.tensors("cpu")
    assert t is port.tensors(torch.device("cpu"))
    assert all(x.dtype == torch.int64 for x in t)
    assert torch.equal(t.to_vn_perm, torch.as_tensor(port.to_vn_perm, dtype=torch.int64))


def test_wlan_layout_shape_and_batch_tile():
    port, _ = _layouts("wlan-1296")
    assert port.n_edges == 4644
    assert [(g.degree, g.num_nodes) for g in port.cn_groups] == [(7, 540), (8, 108)]
    assert [(g.degree, g.num_nodes) for g in port.vn_groups] == [
        (2, 594), (3, 486), (4, 54), (11, 162),
    ]
    # (2 x 4644 + 1296) bytes per codeword: 16 codewords fit 227 KB.
    for t in (16, 32):
        assert pick_batch_tile(port, t, t) == 16
        assert shared_bytes(port, 16, t, t) <= MAX_SHARED_BYTES
        assert shared_bytes(port, 32, t, t) > MAX_SHARED_BYTES


def test_layout_too_large_for_one_cta_raises():
    port, _ = _layouts("qc-96")
    huge = dataclasses.replace(port, n_edges=200_000)
    with pytest.raises(ValueError, match="shared memory"):
        pick_batch_tile(huge, 16, 16)
