"""The fused float decoder K2's pass order as a plain per-pass model, and
K6's copy schedule.

K2 (``csrc/float_fused.cu``) runs two passes a body. Its CN pass also takes
the parity of each check's inputs, the syndrome of A after the body before;
with early exit, the barrier after it ends the tile (iters = i, no
unsatisfied check) when no check of any codeword is odd. Its VN pass also
writes the totals ch + ((m0 + m1) + ...) to the output plane (every body
with early exit, the last body without), so a tile that leaves holds the
decision of its last body although the CN pass after it overwrote B. One
parity-only pass over A after the last body reports the counts; i_max 1
runs that pass alone and decides ch + 0. :func:`k2_passes` runs that order
pass by pass, tile by tile, with the port's node rules. It must equal the
plain twin ``float_decode_tiled``, the JAX package's ``FusedFloatDecoder``
in interpret mode and its whole-batch decoders on each tile.

Inputs are made with numpy from a seed: the 96-variable QC code of
tests/test_float_fused.py and the 1920-variable IRA code of
tests/test_float_hbm.py (degree-1 variables), tiles of 8. Min-sum compares
with ``==`` (+0 == -0), BP with ``==`` against the port's twin (the same
torch operations) and within ``BP_RTOL`` against JAX.
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
from informationbottleneckdecodingldpc_tpu.kernels.float_fused import (
    FusedFloatDecoder as JaxFusedFloatDecoder,
)
from informationbottleneckdecodingldpc_torch.decode import DecodeLayout
from informationbottleneckdecodingldpc_torch.decode.common import (
    DecodeResult,
    gather_node_values_per_group,
    group_planes,
    node_outputs_to_natural_order,
    unsatisfied_checks,
)
from informationbottleneckdecodingldpc_torch.kernels import float_decode_tiled, hbm_copy
from informationbottleneckdecodingldpc_torch.kernels.ib_lut_fused import mean_iterations
from informationbottleneckdecodingldpc_torch.ops.float_ops import (
    LLR_MAX,
    cn_boxplus_leave_one_out,
    cn_minsum_leave_one_out,
    sum_planes,
)

BP_RTOL = 1e-5  # as in tests/test_torch_float.py
CN_RULES = {"minsum": cn_minsum_leave_one_out, "bp": cn_boxplus_leave_one_out}
JAX_DECODERS = {"minsum": jax_min_sum_decode, "bp": jax_bp_decode}
TILE = 8


def cn_pass(layout, a, rule):
    """A -> B (VN view) and, per codeword, the checks whose inputs in A hold
    an odd number of negative values."""
    idx = layout.tensors("cpu")
    planes, odd = [], torch.zeros(a.shape[1], dtype=torch.int32)
    for g in layout.cn_groups:
        m = group_planes(a, g)
        planes.append(CN_RULES[rule](m).reshape(-1, a.shape[1]))
        odd += ((m < 0).sum(0) % 2).sum(0, dtype=torch.int32)
    return torch.cat(planes)[idx.to_vn_perm], odd


def vn_pass(layout, b, chg):
    """B -> A (CN view) and the totals ch + ((m0 + m1) + ...) at the natural
    variable index; a degree-1 node forwards clip(ch), its total is ch + m0."""
    idx = layout.tensors("cpu")
    outs, totals = [], []
    for g, ch in zip(layout.vn_groups, chg):
        m = group_planes(b, g)
        total = ch + sum_planes(m)
        out = ch[None] if g.degree == 1 else total[None] - m
        outs.append(torch.clamp(out, -LLR_MAX, LLR_MAX).reshape(-1, b.shape[1]))
        totals.append(total)
    return torch.cat(outs)[idx.to_cn_perm], node_outputs_to_natural_order(layout, totals)


def k2_passes(layout, llrs, rule, batch_tile, max_iters, early_exit):
    """K2's passes in plain torch, one zero-padded tile at a time: the decode
    result and each tile's passes ('cn', 'vn', 'parity') in order."""
    idx = layout.tensors("cpu")
    batch = llrs.shape[1]
    pad = (-batch) % batch_tile
    padded = torch.nn.functional.pad(llrs, (0, pad))
    outs, unsats, per_codeword, traces = [], [], [], []
    for b0 in range(0, batch + pad, batch_tile):
        ch = padded[:, b0 : b0 + batch_tile]
        chg = gather_node_values_per_group(layout, ch)
        a = ch[idx.cn_edge_var]  # seed
        unsat = torch.zeros(batch_tile, dtype=torch.int32)
        out, trace = None, []
        bodies = max(max_iters - 1, 0)
        iters, left = bodies, False
        for i in range(bodies):
            b, odd = cn_pass(layout, a, rule)
            trace.append("cn")
            if early_exit and i >= 1 and not bool((odd > 0).any()):  # the barrier's OR
                iters, left = i, True
                break
            a, totals = vn_pass(layout, b, chg)
            trace.append("vn")
            if early_exit or i == bodies - 1:
                out = totals  # written to the output plane
        if not left:
            unsat = unsatisfied_checks(layout, a < 0)
            trace.append("parity")
            if bodies == 0:
                out = ch + 0.0  # the decision of a zero B
        outs.append(out)
        unsats.append(unsat)
        per_codeword.append(torch.full((batch_tile,), iters, dtype=torch.int32))
        traces.append(trace)
    result = DecodeResult(
        outputs=torch.cat(outs, dim=1)[:, :batch],
        iterations=mean_iterations(torch.cat(per_codeword)[:batch]),
        unsatisfied=torch.cat(unsats)[:batch],
    )
    return result, traces


def bodies_of(trace) -> int:
    return trace.count("vn")


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


@pytest.mark.parametrize("rule", ["minsum", "bp"])
@pytest.mark.parametrize("early_exit", [True, False])
@pytest.mark.parametrize("max_iters", [1, 2, 3])
def test_k2_passes_match_twin_and_jax_kernel_at_the_loop_bounds(qc96, rule, early_exit, max_iters):
    """i_max 1 (the parity pass alone, ch + 0), 2 (one body: no in-loop exit
    test) and 3 (one exit test, after body 0), on three tiles of 8, the last
    one padded, with the mean high enough that a min-sum tile leaves after
    one body."""
    layout, jlayout = qc96
    llrs = _llrs(max_iters, (layout.n_vars, 20), mean=3.0, std=1.6)
    got, traces = k2_passes(layout, llrs, rule, TILE, max_iters, early_exit)
    assert _same(got, float_decode_tiled(layout, llrs, rule, TILE, max_iters, early_exit))
    want = JaxFusedFloatDecoder(
        jlayout, rule, max_iters=max_iters, early_exit=early_exit, batch_tile=TILE,
        interpret=True,
    )(jnp.asarray(llrs.numpy()))
    _close(rule, got.outputs, want.outputs)
    assert np.array_equal(got.unsatisfied.numpy(), np.asarray(want.unsatisfied))
    assert float(got.iterations) == float(want.iterations)
    bodies = max(max_iters - 1, 0)
    for trace in traces:
        if trace[-1] == "parity":
            assert trace == ["cn", "vn"] * bodies + ["parity"]
        else:  # left after body 0 at the exit test of body 1
            assert early_exit and max_iters == 3 and trace == ["cn", "vn", "cn"]
    if max_iters == 1:
        assert _equal(got.outputs, llrs)
    if early_exit and max_iters == 3 and rule == "minsum":
        assert ["cn", "vn", "cn"] in traces  # the middle tile leaves


@pytest.mark.parametrize("rule", ["minsum", "bp"])
def test_k2_passes_leave_after_odd_even_and_no_bodies(ira, rule):
    """Four tiles at four signal levels: three leave after bodies of both
    parities, the last runs to i_max. Each tile equals the JAX whole-batch
    decoder on it, and the whole batch the twin. The IRA code's degree-1
    parity variables decide ch + m0."""
    layout, jlayout = ira
    assert any(g.degree == 1 for g in layout.vn_groups)
    llrs = torch.cat(
        [_llrs(0, (layout.n_vars, TILE), mean=m, std=1.0) for m in (4.0, 3.0, 2.5)]
        + [_llrs(1, (layout.n_vars, TILE), mean=0.5, std=1.6)],
        dim=1,
    )
    got, traces = k2_passes(layout, llrs, rule, TILE, 12, early_exit=True)
    bodies = [bodies_of(t) for t in traces]
    assert {b % 2 for b in bodies[:3]} == {0, 1} and max(bodies[:3]) < 11, bodies
    assert bodies[3] == 11 and traces[3][-1] == "parity"
    for t, b in zip(traces[:3], bodies[:3]):
        assert t == ["cn", "vn"] * b + ["cn"]  # no parity pass, no decision pass
    assert _same(got, float_decode_tiled(layout, llrs, rule, TILE, 12))
    for t, b0 in enumerate(range(0, llrs.shape[1], TILE)):
        tile = llrs[:, b0 : b0 + TILE]
        want = JAX_DECODERS[rule](jlayout, jnp.asarray(tile.numpy()), max_iters=12, early_exit=True)
        assert int(want.iterations) == bodies[t]
        _close(rule, got.outputs[:, b0 : b0 + TILE], want.outputs)
        assert np.array_equal(got.unsatisfied[b0 : b0 + TILE].numpy(), np.asarray(want.unsatisfied))


@pytest.mark.parametrize("rule", ["minsum", "bp"])
@pytest.mark.parametrize("max_iters", [1, 2, 3, 6])
def test_k2_passes_without_early_exit_match_twin(ira, rule, max_iters):
    """Without early exit only the last body writes the decision and one
    parity pass follows it, on a batch of 20 (the last tile padded)."""
    layout, _ = ira
    llrs = _llrs(max_iters, (layout.n_vars, 20))
    got, traces = k2_passes(layout, llrs, rule, TILE, max_iters, early_exit=False)
    bodies = max(max_iters - 1, 0)
    assert traces == [["cn", "vn"] * bodies + ["parity"]] * 3
    assert _same(got, float_decode_tiled(layout, llrs, rule, TILE, max_iters, early_exit=False))


# -- K6's schedule ------------------------------------------------------------------

C = hbm_copy.CHUNK_BYTES


@pytest.mark.parametrize(
    "nbytes, blocks",
    [
        (0, 132),
        (1, 132),
        (15, 4),
        (C - 1, 2),
        (C, 132),
        (C + 1, 132),
        (5 * C + 17, 3),
        (133 * C, 132),  # block 0 takes two chunks
        (256 * 1024 * 1024, 132),  # the bandwidth buffer: no tail
        (256 * 1024 * 1024 + 12345, 132),
    ],
)
def test_k6_spans_cover_every_byte_once(nbytes, blocks):
    spans = hbm_copy.copy_spans(nbytes, blocks)
    covered = np.zeros(nbytes, dtype=np.int8)
    per_block = np.zeros(blocks, dtype=np.int64)
    for start, stop, block, by in spans:
        covered[start:stop] += 1
        if by == "bulk":  # one whole chunk
            assert start % C == 0 and stop - start == C
            per_block[block] += 1
        else:  # the tail, fewer than a chunk, after every chunk, by the last block
            assert (start, stop, block) == (nbytes // C * C, nbytes, blocks - 1)
            assert 0 < stop - start < C
    assert np.all(covered == 1)
    assert per_block.max() - per_block.min() <= 1  # balanced over the grid
    # Neighbouring chunks go to neighbouring blocks: the grid moves one window.
    bulk = [block for _, _, block, by in spans if by == "bulk"]
    assert bulk == [k % blocks for k in range(nbytes // C)]


def test_k6_plain_copy_of_a_ragged_size():
    src = torch.as_tensor(np.random.default_rng(6).integers(0, 256, 3 * C + 7, dtype=np.uint8))
    dst = torch.zeros_like(src)
    hbm_copy.copy(src, dst, passes=2)
    assert torch.equal(src, dst) and hbm_copy.launches["hbm_copy"] == 0
