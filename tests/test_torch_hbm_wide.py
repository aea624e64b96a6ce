"""The wide device-memory decoders K3 and K4 (``csrc/hbm_wide.cuh``): K4's
launch order as a plain per-pass model, and what the wrappers refuse.

K4 counts the syndrome of a body's VN->CN messages inside the next body's
CN pass, marks the tile done in the exit step after it, and keeps the
CN->VN view twice (body i writes B[i % 2]) so that the decision of a tile
that leaves after body i reads body i's messages. :func:`k4_passes` runs
that order pass by pass, tile by tile, with the port's node rules; it must
equal the plain twin ``float_decode_tiled`` (K2's exit convention) and the
JAX package: its whole-batch decoders on each tile, and its ``float_hbm``
kernel in interpret mode, which agrees with early exit off and, with early
exit on, leaves every tile one body later (tests/test_torch_hbm.py).

Inputs are made with numpy from a seed: the 1920-variable DVB-S2-like IRA
code and the 96-variable QC code of tests/test_float_hbm.py, tiles of 8.
Min-sum compares with ``==`` (+0 == -0), BP with ``==`` against the port's
twin (the same torch operations) and within ``BP_RTOL`` against JAX.
"""

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
from informationbottleneckdecodingldpc_tpu.decode import (
    DecodeLayout as JaxLayout,
    belief_propagation_decode as jax_bp_decode,
    min_sum_decode as jax_min_sum_decode,
)
from informationbottleneckdecodingldpc_tpu.kernels.float_hbm import (
    HBMFloatDecoder as JaxHBMFloatDecoder,
)
from informationbottleneckdecodingldpc_torch.cli import kernel_times
from informationbottleneckdecodingldpc_torch.construct import DecoderConfig
from informationbottleneckdecodingldpc_torch.decode import DecodeLayout
from informationbottleneckdecodingldpc_torch.decode.common import (
    DecodeResult,
    apply_per_cn_group,
    apply_per_vn_group,
    gather_node_values_per_group,
    group_planes,
    node_outputs_to_natural_order,
    unsatisfied_checks,
)
from informationbottleneckdecodingldpc_torch.kernels import (
    HBMFloatDecoder,
    HBMFusedIBDecoder,
    float_decode_tiled,
)
from informationbottleneckdecodingldpc_torch.kernels.float_hbm import K4_VEC
from informationbottleneckdecodingldpc_torch.kernels.ib_lut_fused import mean_iterations
from informationbottleneckdecodingldpc_torch.kernels.ib_lut_hbm import (
    HBM_MAX_TILE,
    K3_VEC,
    check_wide_tile,
    tile_scratch,
)
from informationbottleneckdecodingldpc_torch.models import get_model
from informationbottleneckdecodingldpc_torch.ops.float_ops import (
    cn_boxplus_leave_one_out,
    cn_minsum_leave_one_out,
    sum_planes,
    vn_sum_leave_one_out,
)
from informationbottleneckdecodingldpc_torch.sim import BERSimulator, engine

BP_RTOL = 1e-5  # as in tests/test_torch_float.py
CN_RULES = {"minsum": cn_minsum_leave_one_out, "bp": cn_boxplus_leave_one_out}
JAX_DECODERS = {"minsum": jax_min_sum_decode, "bp": jax_bp_decode}
TILE = 8


def k4_passes(layout, llrs, rule, batch_tile, max_iters, early_exit):
    """K4's launches (csrc/float_hbm.cu ``decode``) in plain torch, one
    zero-padded tile at a time: the decode result and each tile's bodies.

    seed; per body i: CN pass A -> B[i % 2] (with early exit and i >= 1
    counting the syndrome of its input A), the exit step for body i-1, VN
    pass B[i % 2] -> A (unsat zeroed); after the last body the syndrome of A
    and its exit step; the decision from B[(bodies - 1) % 2]."""
    idx = layout.tensors("cpu")
    batch = llrs.shape[1]
    pad = (-batch) % batch_tile
    padded = torch.nn.functional.pad(llrs, (0, pad))

    def syndrome(view):
        return unsatisfied_checks(layout, view < 0)

    outs, unsats, per_codeword, bodies_per_tile = [], [], [], []
    for b0 in range(0, batch + pad, batch_tile):
        ch = padded[:, b0 : b0 + batch_tile]
        chg = gather_node_values_per_group(layout, ch)
        a = ch[idx.cn_edge_var]  # seed
        b = torch.zeros((2, *a.shape))  # a zero B when no body runs
        unsat = torch.zeros(batch_tile, dtype=torch.int32)
        bodies, done = 0, False
        if max_iters <= 1:
            unsat = unsat + syndrome(a)
        for i in range(max_iters - 1):
            count = early_exit and i >= 1
            if count:
                unsat = unsat + syndrome(a)
            b[i % 2] = apply_per_cn_group(layout, a, lambda m, g: CN_RULES[rule](m))[
                idx.to_vn_perm
            ]
            if count:  # the exit step for body i-1
                bodies = i
                if not bool((unsat > 0).any()):
                    done = True
                    break
            unsat = torch.zeros_like(unsat)  # the VN pass
            a = apply_per_vn_group(
                layout, b[i % 2], chg, lambda c, m, g: vn_sum_leave_one_out(c, m)
            )[idx.to_cn_perm]
        if not done and max_iters >= 2:
            unsat = unsat + syndrome(a)
            bodies = max_iters - 1
        last = b[(bodies + 1) % 2]
        outs.append(
            node_outputs_to_natural_order(
                layout,
                [c + sum_planes(group_planes(last, g)) for g, c in zip(layout.vn_groups, chg)],
            )
        )
        unsats.append(unsat)
        per_codeword.append(torch.full((batch_tile,), bodies, dtype=torch.int32))
        bodies_per_tile.append(bodies)
    result = DecodeResult(
        outputs=torch.cat(outs, dim=1)[:, :batch],
        iterations=mean_iterations(torch.cat(per_codeword)[:batch]),
        unsatisfied=torch.cat(unsats)[:batch],
    )
    return result, bodies_per_tile


@pytest.fixture(scope="module")
def ira():
    H = dvbs2_like_parity_check(1920, 960, seed=9)
    g = TannerGraph.from_check_matrix(H)
    ck, vk = dvbs2_layout_node_keys(1920, 960)
    ek_csr, ek_csc = dvbs2_layout_edge_keys(H, 960)
    keys = dict(cn_node_key=ck, vn_node_key=vk, cn_edge_key=ek_csr, vn_edge_key=ek_csc)
    return DecodeLayout.from_graph(g, **keys), JaxLayout.from_graph(g, **keys)


@pytest.fixture(scope="module")
def qc96():
    g = TannerGraph.from_check_matrix(regular_qc_parity_check(96, 3, 6, seed=7))
    return DecodeLayout.from_graph(g), JaxLayout.from_graph(g)


def _llrs(seed, shape, mean=1.0, std=1.6):
    return torch.as_tensor(np.random.default_rng(seed).normal(mean, std, shape).astype(np.float32))


def _equal(got: torch.Tensor, want) -> bool:
    """Equal as values: +0 == -0 for floats."""
    want = np.asarray(want)
    return got.shape == want.shape and bool(np.all(got.numpy() == want))


def _same(got, want) -> bool:
    return (
        _equal(got.outputs, want.outputs)
        and torch.equal(got.unsatisfied, want.unsatisfied)
        and float(got.iterations) == float(want.iterations)
    )


def _close(rule, got: torch.Tensor, want) -> None:
    if rule == "minsum":
        assert _equal(got, want)
    else:
        want = np.asarray(want)
        err = np.abs(got.numpy() - want)
        assert np.all(err <= BP_RTOL * np.maximum(1.0, np.abs(want))), err.max()


def _jax_kernel(jlayout, llrs, rule, max_iters, early_exit):
    return JaxHBMFloatDecoder(
        jlayout, rule, max_iters=max_iters, early_exit=early_exit, batch_tile=TILE,
        interpret=True,
    )(jnp.asarray(llrs.numpy()))


@pytest.mark.parametrize("rule", ["minsum", "bp"])
@pytest.mark.parametrize(
    "code, batch, max_iters",
    [
        ("ira", 8, 5),  # every body, the syndrome pass only after the last
        ("qc96", 20, 4),  # three tiles, the last one padded
        ("qc96", 8, 2),  # one body
    ],
)
def test_k4_passes_without_early_exit_match_twin_and_jax_kernel(
    ira, qc96, rule, code, batch, max_iters
):
    layout, jlayout = {"ira": ira, "qc96": qc96}[code]
    llrs = _llrs(batch, (layout.n_vars, batch))
    got, bodies = k4_passes(layout, llrs, rule, TILE, max_iters, early_exit=False)
    assert bodies == [max_iters - 1] * len(bodies)
    assert _same(got, float_decode_tiled(layout, llrs, rule, TILE, max_iters, early_exit=False))
    want = _jax_kernel(jlayout, llrs, rule, max_iters, early_exit=False)
    _close(rule, got.outputs, want.outputs)
    assert np.array_equal(got.unsatisfied.numpy(), np.asarray(want.unsatisfied))
    assert float(got.iterations) == float(want.iterations) == max_iters - 1


@pytest.mark.parametrize("rule", ["minsum", "bp"])
def test_k4_passes_exit_after_odd_and_even_bodies(ira, rule):
    """Three tiles at three signal levels leave after 1, 2 and 3 bodies: the
    decision reads B[0] after an odd count and B[1] after an even one. Each
    tile equals the JAX whole-batch decoder on it; the JAX kernel leaves
    every tile one body later."""
    layout, jlayout = ira
    llrs = torch.cat(
        [_llrs(0, (layout.n_vars, TILE), mean=m, std=1.0) for m in (4.0, 3.0, 2.5)], dim=1
    )
    got, bodies = k4_passes(layout, llrs, rule, TILE, 12, early_exit=True)
    assert {b % 2 for b in bodies} == {0, 1} and max(bodies) < 11, bodies
    assert _same(got, float_decode_tiled(layout, llrs, rule, TILE, 12))
    for t, b0 in enumerate(range(0, llrs.shape[1], TILE)):
        tile = llrs[:, b0 : b0 + TILE]
        want = JAX_DECODERS[rule](jlayout, jnp.asarray(tile.numpy()), max_iters=12, early_exit=True)
        assert int(want.iterations) == bodies[t]
        _close(rule, got.outputs[:, b0 : b0 + TILE], want.outputs)
        assert np.array_equal(got.unsatisfied[b0 : b0 + TILE].numpy(), np.asarray(want.unsatisfied))
    late = _jax_kernel(jlayout, llrs, rule, 12, early_exit=True)
    assert float(late.iterations) == float(got.iterations) + 1


@pytest.mark.parametrize("rule", ["minsum", "bp"])
@pytest.mark.parametrize("max_iters, early_exit", [(1, True), (2, True), (12, True)])
def test_k4_passes_match_twin_at_the_loop_bounds(qc96, rule, max_iters, early_exit):
    """i_max 1 (no body: the syndrome of the seeded view, a zero B), i_max 2
    (one body, no in-loop exit step) and a low-SNR run to i_max, against the
    twin; i_max 1 also against the JAX kernel."""
    layout, jlayout = qc96
    llrs = _llrs(3, (layout.n_vars, 2 * TILE))
    got, bodies = k4_passes(layout, llrs, rule, TILE, max_iters, early_exit)
    assert _same(got, float_decode_tiled(layout, llrs, rule, TILE, max_iters, early_exit))
    if max_iters == 1:
        assert bodies == [0, 0] and _equal(got.outputs, llrs)
        want = _jax_kernel(jlayout, llrs, rule, 1, early_exit)
        assert _equal(got.outputs, want.outputs)
        assert np.array_equal(got.unsatisfied.numpy(), np.asarray(want.unsatisfied))


# -- the wrappers ----------------------------------------------------------------

@pytest.mark.parametrize(
    "batch_tile, vec, message",
    [
        (100, 8, "8 columns per thread do not divide batch_tile 100"),
        (130, 4, "4 columns per thread do not divide batch_tile 130"),
        (2048, 8, "at most 1024 codewords, not 2048"),
        (0, 4, "at most 1024 codewords, not 0"),
    ],
)
def test_check_wide_tile_refuses(batch_tile, vec, message):
    with pytest.raises(ValueError, match=message):
        check_wide_tile(batch_tile, vec)


@pytest.mark.parametrize(
    "batch_tile, vec",
    [(8, K3_VEC), (200, K3_VEC), (HBM_MAX_TILE, K3_VEC), (4, K4_VEC), (12, K4_VEC),
     (HBM_MAX_TILE, K4_VEC)],
)
def test_check_wide_tile_takes_every_tile_the_width_divides(batch_tile, vec):
    check_wide_tile(batch_tile, vec)


def test_wide_tiles_refused_before_the_card(qc96):
    """A tile the wide kernels do not take raises in the wrapper before any
    CUDA call (meta tensors stand in for CUDA ones)."""
    layout = qc96[0]
    tables = DecoderConfig.load("results/configs/wlan_T16_0.8.npz").tables
    wlan = get_model("wlan-1296").make_layout()
    clusters = torch.zeros((wlan.n_vars, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match=f"{K3_VEC} columns per thread do not divide batch_tile 100"):
        HBMFusedIBDecoder(wlan, tables, batch_tile=100)._launch(clusters)
    with pytest.raises(ValueError, match="at most 1024 codewords, not 2048"):
        HBMFusedIBDecoder(wlan, tables, batch_tile=2048)._launch(clusters)
    llrs = torch.zeros((layout.n_vars, 4), device="meta")
    with pytest.raises(ValueError, match="4 columns per thread do not divide batch_tile 6"):
        HBMFloatDecoder(layout, "minsum", batch_tile=6)._launch(llrs)
    with pytest.raises(ValueError, match="at most 1024 codewords, not 1028"):
        HBMFloatDecoder(layout, "bp", batch_tile=1028)._launch(llrs)


def test_simulator_on_a_card_refuses_the_tile_when_built(qc96, monkeypatch):
    """backend='hbm' on a CUDA device checks the tile when the simulator is
    built (the device is only named here: building touches no card); on the
    CPU the plain twin takes any tile."""
    layout = qc96[0]
    kw = dict(max_iters=5, backend="hbm")
    assert BERSimulator(layout, "minsum", device="cpu", batch_tile=6, **kw).backend == "hbm"
    monkeypatch.setattr(engine, "resolve_device", lambda device: torch.device("cuda"))
    with pytest.raises(ValueError, match="4 columns per thread do not divide batch_tile 6"):
        BERSimulator(layout, "minsum", device="cuda", batch_tile=6, **kw)
    sim = BERSimulator(layout, "bp", device="cuda", batch_tile=200, **kw)
    assert sim.fused_decoder.batch_tile == 200


def test_kernel_times_needs_a_card():
    with pytest.raises(RuntimeError, match="CUDA device only"):
        kernel_times.main([])


def test_tile_scratch_k4_has_two_vn_views(qc96):
    layout = qc96[0]
    a, b, chg, unsat, state = tile_scratch(
        layout, 20, 8, torch.float32, "cpu", zero_vn_view=True, vn_views=2
    )
    assert a.shape == (3, layout.n_edges, 8)
    assert b.shape == (2, 3, layout.n_edges, 8) and not b.any()
    assert chg.shape == (3, layout.n_vars, 8)
    assert unsat.shape == (3, 8) and state.shape == (3, 2)
    k3 = tile_scratch(layout, 20, 8, torch.uint8, "cpu")
    assert k3[0].shape == k3[1].shape == (3, layout.n_edges, 8)
