"""K4's node-state min-sum path (``csrc/float_hbm.cu``) as a plain model.

On the node-state path each check keeps one record a codeword (the
magnitude of its outputs at the slot of its least input and at the others,
and a 16-bit code: the sign of each output and that slot) and each variable
its total T, in
place of K4's three float32 views per edge. :func:`state_model` runs that
path's launch order in plain torch, tile by tile: the CN pass rebuilds each
input ``clip(T_v - c->v_old)`` from T and the check's old record (body 0 the
raw channel LLR, a degree-1 variable ``clip(ch)``), counts their syndrome
and folds them into the new record with ``minsum_fold``'s order of
min/max; the VN pass rebuilds each ``c->v`` from the records and writes T
as ``ch + ((m0 + m1) + ...)``; the decision is T. :func:`view_model` runs
K4's view path in the same order with ``minsum_fold``'s arithmetic per edge
(``out_j = s_j * mag_j``, ``s_j = +0`` when another input is zero).

The two must agree bit for bit (outputs compared as int32, so the sign of a
zero counts), as must their counts and mean bodies. Against the plain twin
``float_decode_tiled`` the outputs are equal as values and bit for bit
except where both are zeros: its prefix/suffix sign product may give -0
where ``minsum_fold`` gives +0 (K4's min-sum is exact up to the sign of a
zero, ``csrc/float_groups.cuh``); inputs with no zero agree bit for bit.

Inputs are made with numpy from a seed on the port's 1920-variable
DVB-S2-like IRA code (check degrees 6 and 7, one degree-1 variable) and the
96-variable regular QC code (check degree 6).
"""

import numpy as np
import pytest
import torch

from informationbottleneckdecodingldpc_torch.codes import (
    TannerGraph,
    dvbs2_layout_edge_keys,
    dvbs2_layout_node_keys,
    dvbs2_like_parity_check,
    regular_qc_parity_check,
    wlan_80211n_parity_check,
)
from informationbottleneckdecodingldpc_torch.decode import DecodeLayout
from informationbottleneckdecodingldpc_torch.decode.common import DecodeResult
from informationbottleneckdecodingldpc_torch.kernels import HBMFloatDecoder, float_decode_tiled
from informationbottleneckdecodingldpc_torch.kernels.float_hbm import (
    SLOT_BITS,
    STATE_MAX_DEGREE,
    state_arrays,
    state_scratch,
    state_slice,
    takes_node_state,
)
from informationbottleneckdecodingldpc_torch.kernels.ib_lut_fused import mean_iterations
from informationbottleneckdecodingldpc_torch.ops.float_ops import LLR_MAX

def clip(x):
    return torch.clamp(x, -LLR_MAX, LLR_MAX)


def fold_stats(planes):
    """``minsum_fold``'s min1, min2 (its fminf/fmaxf order), zero count and
    negative parity over [d, n, columns] planes."""
    a = planes.abs()
    min1, min2 = a[0], torch.full_like(a[0], float("inf"))
    for k in range(1, planes.shape[0]):
        min2 = torch.minimum(min2, torch.maximum(min1, a[k]))
        min1 = torch.minimum(min1, a[k])
    return min1, min2, (planes == 0).sum(0), (planes < 0).sum(0) % 2


def minsum_fold_planes(planes):
    """``minsum_fold`` (D >= 3) per edge: s_j * (|m_j| == min1 ? min2 : min1)."""
    min1, min2, zeros, negs = fold_stats(planes)
    out = []
    for m in planes:
        s = torch.where(
            zeros - (m == 0).long() > 0,
            torch.zeros_like(m),
            torch.where((negs ^ (m < 0).long()) != 0, -1.0, 1.0),
        )
        out.append(s * torch.where(m.abs() == min1, min2, min1))
    return torch.stack(out)


def syndrome(layout, cn_view):
    """Per column, the checks whose inputs hold an odd count of negatives."""
    u = torch.zeros(cn_view.shape[-1], dtype=torch.int32)
    for g in layout.cn_groups:
        planes = cn_view[g.offset : g.offset + g.degree * g.num_nodes]
        neg = (planes < 0).reshape(g.degree, g.num_nodes, -1)
        u += (neg.sum(0) % 2).sum(0, dtype=torch.int32)
    return u


def variable_totals(layout, vn_view, chg):
    """T = ch + ((m0 + m1) + ...) per variable, group order."""
    totals = []
    for g, ch in zip(layout.vn_groups, torch.split(chg, [g.num_nodes for g in layout.vn_groups])):
        planes = vn_view[g.offset : g.offset + g.degree * g.num_nodes].reshape(
            g.degree, g.num_nodes, -1
        )
        s = planes[0]
        for k in range(1, g.degree):
            s = s + planes[k]
        totals.append(ch + s)
    return torch.cat(totals)


def tile_loop(max_iters, early_exit, cn_pass, vn_pass, final_syndrome):
    """K4's launch order on one tile: ``cn_pass(first)`` returns the syndrome
    of its inputs; the exit step after it; ``vn_pass()``; after the last
    body ``final_syndrome(first)``. Returns the counts and the bodies run."""
    bodies = 0
    if max_iters <= 1:
        return final_syndrome(True), 0
    for i in range(max_iters - 1):
        u = cn_pass(i == 0)
        if early_exit and i >= 1:
            bodies = i
            if not bool((u > 0).any()):
                return u, bodies
        vn_pass()
    return final_syndrome(False), max_iters - 1


def in_tiles(layout, llrs, batch_tile, decode_tile):
    """``decode_tile(ch [n_vars, tile]) -> (outputs, unsat, bodies)`` on each
    zero-padded tile, as one DecodeResult."""
    batch = llrs.shape[1]
    padded = torch.nn.functional.pad(llrs, (0, (-batch) % batch_tile))
    outs, unsats, bodies = [], [], []
    for b0 in range(0, padded.shape[1], batch_tile):
        out, u, b = decode_tile(padded[:, b0 : b0 + batch_tile])
        outs.append(out)
        unsats.append(u)
        bodies.append(torch.full((batch_tile,), b, dtype=torch.int32))
    return DecodeResult(
        outputs=torch.cat(outs, 1)[:, :batch],
        iterations=mean_iterations(torch.cat(bodies)[:batch]),
        unsatisfied=torch.cat(unsats)[:batch],
    )


def view_model(layout, llrs, batch_tile, max_iters, early_exit):
    """K4's view path with ``minsum_fold``'s arithmetic."""
    idx = layout.tensors("cpu")
    one = [g.degree == 1 for g in layout.vn_groups]

    def decode_tile(ch):
        chg = ch[idx.vn_node_order]
        v = {"A": ch[idx.cn_edge_var], "B": torch.zeros(layout.n_edges, ch.shape[1])}

        def cn_pass(first):
            planes = []
            for g in layout.cn_groups:
                p = v["A"][g.offset : g.offset + g.degree * g.num_nodes]
                planes.append(minsum_fold_planes(p.reshape(g.degree, g.num_nodes, -1)))
            v["new_B"] = torch.cat([p.reshape(-1, ch.shape[1]) for p in planes])[idx.to_vn_perm]
            return syndrome(layout, v["A"])

        def vn_pass():
            v["B"] = v["new_B"]
            totals = torch.split(
                variable_totals(layout, v["B"], chg), [g.num_nodes for g in layout.vn_groups]
            )
            rows = []
            for g, t, c, deg1 in zip(
                layout.vn_groups, totals, torch.split(chg, [g.num_nodes for g in layout.vn_groups]), one
            ):
                planes = v["B"][g.offset : g.offset + g.degree * g.num_nodes].reshape(
                    g.degree, g.num_nodes, -1
                )
                rows.append((clip(c)[None] if deg1 else clip(t[None] - planes)).reshape(-1, ch.shape[1]))
            v["A"] = torch.cat(rows)[idx.to_cn_perm]

        u, bodies = tile_loop(
            max_iters, early_exit, cn_pass, vn_pass, lambda first: syndrome(layout, v["A"])
        )
        return variable_totals(layout, v["B"], chg)[idx.vn_node_unperm], u, bodies

    return in_tiles(layout, llrs, batch_tile, decode_tile)


ARGMIN_SHIFT = STATE_MAX_DEGREE  # the code: a sign bit a slot, then the argmin


def record_of(planes):
    """Each check's record (csrc/float_hbm.cu ``MinSumFold::record``) from
    its inputs [d, n, columns]: the magnitude of its outputs off the argmin
    slot (min1, or 0 where an input is zero) and at it (min2, or 0 where two
    are), and the code: the sign of each nonzero output, then the argmin, the
    first slot that holds min1."""
    d = planes.shape[0]
    min1, min2, zeros, negs = fold_stats(planes)
    argmin = (planes.abs() == min1).long().argmax(0)
    signs = sum(((negs ^ (planes[j] < 0).long()) << j) for j in range(d))
    signs = torch.where(zeros == 0, signs, torch.where(zeros == 1, signs & (1 << argmin), 0))
    rest = torch.where(zeros == 0, min1, torch.zeros_like(min1))
    at_min = torch.where(zeros < 2, min2, torch.zeros_like(min2))
    return rest, at_min, signs | argmin << ARGMIN_SHIFT


def message(codes, rest, at_min, rows, slots):
    """Each edge's output rebuilt from its check's record: the argmin's
    magnitude at the argmin slot, the others' elsewhere, with the slot's
    sign bit."""
    code = codes[rows]
    mag = torch.where((code >> ARGMIN_SHIFT) == slots[:, None], at_min[rows], rest[rows])
    sign = ((code >> slots[:, None] & 1) << 31).to(torch.int32)
    return (mag.view(torch.int32) | sign).view(torch.float32)


def state_model(layout, llrs, batch_tile, max_iters, early_exit):
    """K4's node-state path: records and totals, through the wrapper's index
    arrays (``state_arrays``)."""
    idx = layout.tensors("cpu")
    arrays = {k: torch.as_tensor(v, dtype=torch.int64) for k, v in state_arrays(layout).items()}
    cn_var = arrays["cn_var"]
    degree1 = cn_var < 0
    var = torch.where(degree1, ~cn_var, cn_var)
    vn_rows, vn_slots = arrays["vn_check"] >> SLOT_BITS, arrays["vn_check"] & (2**SLOT_BITS - 1)
    # Each CN-view row's check and slot: the inverse route of vn_check.
    cn_check = arrays["vn_check"][torch.as_tensor(layout.cn_to_vn_row, dtype=torch.int64)]
    cn_rows, cn_slots = cn_check >> SLOT_BITS, cn_check & (2**SLOT_BITS - 1)

    def decode_tile(ch):
        chs = ch[idx.vn_node_order]
        cols = ch.shape[1]
        s = {
            "rest": torch.zeros(layout.n_checks, cols),
            "at_min": torch.zeros(layout.n_checks, cols),
            "code": torch.zeros(layout.n_checks, cols, dtype=torch.int64),
            "T": chs + 0.0,
        }

        def inputs(first):
            if first:
                return chs[var]
            old = message(s["code"], s["rest"], s["at_min"], cn_rows, cn_slots)
            return torch.where(degree1[:, None], clip(chs[var]), clip(s["T"][var] - old))

        def cn_pass(first):
            m = inputs(first)
            first_check = 0
            for g in layout.cn_groups:
                d, n = g.degree, g.num_nodes
                planes = m[g.offset : g.offset + d * n].reshape(d, n, cols)
                rows = slice(first_check, first_check + n)
                s["rest"][rows], s["at_min"][rows], s["code"][rows] = record_of(planes)
                first_check += n
            return syndrome(layout, m)

        def vn_pass():
            m = message(s["code"], s["rest"], s["at_min"], vn_rows, vn_slots)
            s["T"] = variable_totals(layout, m, chs)

        u, bodies = tile_loop(
            max_iters, early_exit, cn_pass, vn_pass, lambda first: syndrome(layout, inputs(first))
        )
        return s["T"][idx.vn_node_unperm], u, bodies

    return in_tiles(layout, llrs, batch_tile, decode_tile)


def bits(x):
    return x.contiguous().view(torch.int32)


def layout_of(H, **keys):
    return DecodeLayout.from_graph(TannerGraph.from_check_matrix(H), **keys)


@pytest.fixture(scope="module")
def ira():
    H = dvbs2_like_parity_check(1920, 960, seed=9)
    ck, vk = dvbs2_layout_node_keys(1920, 960)
    ek_csr, ek_csc = dvbs2_layout_edge_keys(H, 960)
    return layout_of(H, cn_node_key=ck, vn_node_key=vk, cn_edge_key=ek_csr, vn_edge_key=ek_csc)


@pytest.fixture(scope="module")
def qc96():
    return layout_of(regular_qc_parity_check(96, 3, 6, seed=7))


def inputs_of(kind, n_vars, batch, seed):
    """LLRs of one kind: ``normal`` (no zero, no tie), ``ties`` (multiples of
    0.5: equal magnitudes and some exact zeros), ``zeros`` / ``negzeros``
    (30% +0 / -0), ``big`` (|LLR| up to about 800, clamped at 150 by the
    VN outputs, the body-0 inputs raw), ``levels`` (a multiple of 24
    columns)."""
    rng = np.random.default_rng(seed)
    shape = (n_vars, batch)
    x = {
        "normal": lambda: rng.normal(1.0, 1.6, shape),
        "ties": lambda: np.round(rng.normal(1.0, 1.6, shape) * 2) / 2,
        "zeros": lambda: np.where(rng.random(shape) < 0.3, 0.0, np.round(rng.normal(1, 2, shape))),
        "negzeros": lambda: np.where(rng.random(shape) < 0.3, -0.0, np.round(rng.normal(1, 2, shape))),
        "big": lambda: rng.normal(0.5, 200.0, shape),
        # Tiles of 8 drawn at three signal levels, which leave after
        # different bodies.
        "levels": lambda: np.concatenate(
            [rng.normal(m, 1.0, (n_vars, 8)) for m in (4.0, 2.7, 2.0)] * (batch // 24), axis=1
        ),
    }[kind]()
    return torch.as_tensor(x.astype(np.float32))


def zero_inputs_per_check(layout, llrs):
    """Per check and column, how many of its body-0 inputs are zero."""
    zero = (llrs[layout.tensors("cpu").cn_edge_var] == 0).long()
    return torch.cat(
        [
            zero[g.offset : g.offset + g.degree * g.num_nodes].reshape(g.degree, g.num_nodes, -1).sum(0)
            for g in layout.cn_groups
        ]
    )


CASES = [  # (code, inputs, batch, tile, max_iters, early exit)
    ("ira", "normal", 8, 8, 6, False),  # one tile, every body
    ("ira", "normal", 24, 8, 50, True),  # three tiles that run every body
    ("ira", "levels", 24, 8, 12, True),  # tiles that leave after odd and even bodies
    ("ira", "levels", 48, 8, 3, True),
    ("ira", "ties", 16, 8, 8, False),
    ("ira", "ties", 16, 8, 50, True),
    ("ira", "zeros", 16, 8, 6, False),
    ("ira", "negzeros", 16, 8, 6, False),
    ("ira", "negzeros", 12, 8, 50, True),  # a padded last tile
    ("ira", "big", 16, 8, 6, False),
    ("ira", "normal", 8, 8, 1, True),  # no body: the decision is ch + 0
    ("ira", "negzeros", 8, 8, 1, True),
    ("ira", "normal", 8, 8, 2, True),  # one body, no in-loop exit step
    ("qc96", "normal", 20, 8, 4, False),
    ("qc96", "zeros", 20, 4, 12, True),
    ("qc96", "big", 16, 16, 12, True),
    ("qc96", "levels", 24, 8, 12, True),
]


@pytest.mark.parametrize("code, kind, batch, tile, max_iters, early_exit", CASES)
def test_node_state_equals_the_view_path_and_the_twin(
    ira, qc96, code, kind, batch, tile, max_iters, early_exit
):
    layout = {"ira": ira, "qc96": qc96}[code]
    llrs = inputs_of(kind, layout.n_vars, batch, seed=len(kind) + batch + max_iters)
    got = state_model(layout, llrs, tile, max_iters, early_exit)
    views = view_model(layout, llrs, tile, max_iters, early_exit)
    twin = float_decode_tiled(layout, llrs, "minsum", tile, max_iters, early_exit)
    assert torch.equal(bits(got.outputs), bits(views.outputs))
    for want in (views, twin):
        assert torch.equal(got.unsatisfied, want.unsatisfied)
        assert bits(got.iterations) == bits(want.iterations)
    assert bool((got.outputs == twin.outputs).all())
    differ = bits(got.outputs) != bits(twin.outputs)
    assert bool((got.outputs[differ] == 0).all())
    if kind in ("normal", "big"):
        assert not bool(differ.any())


def test_the_cases_reach_what_they_name(ira):
    """The inputs hold checks with one zero input and with two or more, -0.0
    inputs, ties of the least magnitudes, |LLR| above the clamp; the IRA
    code has a degree-1 variable on the path; early exit leaves tiles after
    different bodies."""
    layout = ira
    zeros = zero_inputs_per_check(layout, inputs_of("negzeros", layout.n_vars, 16, seed=0))
    assert bool((zeros == 1).any()) and bool((zeros >= 2).any())
    neg = inputs_of("negzeros", layout.n_vars, 16, seed=0)
    assert bool(((neg == 0) & (bits(neg) != 0)).any())
    ties = inputs_of("ties", layout.n_vars, 16, seed=0)
    a = ties[layout.tensors("cpu").cn_edge_var].abs()
    g = layout.cn_groups[-1]
    planes = a[g.offset : g.offset + g.degree * g.num_nodes].reshape(g.degree, g.num_nodes, -1)
    min1, min2, _, _ = fold_stats(planes)
    assert bool((min1 == min2).any())
    assert bool((inputs_of("big", layout.n_vars, 16, seed=0).abs() > LLR_MAX).any())
    assert bool((torch.as_tensor(state_arrays(layout)["cn_var"]) < 0).any())
    llrs = inputs_of("levels", layout.n_vars, 24, seed=len("levels") + 24 + 12)
    per_tile = [
        int(float_decode_tiled(layout, llrs[:, b0 : b0 + 8], "minsum", 8, 12).iterations)
        for b0 in (0, 8, 16)
    ]
    assert len(set(per_tile)) == 3 and {b % 2 for b in per_tile} == {0, 1}, per_tile


def test_state_arrays_route_every_edge(ira):
    """cn_var names each CN-view row's variable (group order; ~v at degree
    1); vn_check names each VN-view row's check (group order) and slot, the
    CN-view row it routes to."""
    layout = ira
    a = state_arrays(layout)
    cn_var, vn_check = a["cn_var"].astype(np.int64), a["vn_check"].astype(np.int64)
    position = np.where(cn_var < 0, ~cn_var, cn_var)
    assert np.array_equal(np.asarray(layout.vn_node_order)[position], layout.cn_edge_var)
    degree = np.concatenate([np.full(g.num_nodes, g.degree) for g in layout.vn_groups])
    assert np.array_equal(cn_var < 0, degree[position] == 1)
    check, slot = vn_check >> SLOT_BITS, vn_check & (2**SLOT_BITS - 1)
    first = np.cumsum([0] + [g.num_nodes for g in layout.cn_groups])
    group = np.searchsorted(first, check, side="right") - 1
    offset = np.array([g.offset for g in layout.cn_groups])[group]
    n = np.array([g.num_nodes for g in layout.cn_groups])[group]
    assert np.array_equal(offset + slot * n + check - first[group], layout.vn_to_cn_row)


def test_node_state_engages_where_min_sum_allows(ira, qc96):
    """Min-sum with check degrees 3 to STATE_MAX_DEGREE takes the node-state
    path; BP, a degree-2 check and a check wider than the code word keep
    the views."""
    wlan = layout_of(wlan_80211n_parity_check())
    wide = layout_of(regular_qc_parity_check(8 * (STATE_MAX_DEGREE + 1), 2, STATE_MAX_DEGREE + 1, seed=1))
    H = regular_qc_parity_check(96, 3, 6, seed=7).tolil()
    H[0, :] = 0
    H[0, 0] = H[0, 1] = 1  # one check of degree 2
    degree2 = layout_of(H.tocsr())
    assert min(g.degree for g in degree2.cn_groups) == 2
    for layout, want in ((ira, True), (qc96, True), (wlan, True), (wide, False), (degree2, False)):
        assert takes_node_state(layout, "minsum") is want
        assert HBMFloatDecoder(layout, "minsum").node_state is want
        assert takes_node_state(layout, "bp") is False
        assert HBMFloatDecoder(layout, "bp").node_state is False


@pytest.mark.parametrize(
    "batch_tile, columns, want",
    [(128, 32, 32), (128, 64, 64), (128, 16, 16), (200, 32, 20), (1024, 32, 32), (36, 32, 12), (4, 32, 4)],
)
def test_state_slice_divides_the_tile(batch_tile, columns, want):
    assert state_slice(batch_tile, columns) == want


def test_state_scratch_shapes(ira):
    layout = ira
    scratch = state_scratch(layout, 200, 128, 32, torch.device("cpu"))
    assert [tuple(x.shape) for x in scratch] == [
        (8, layout.n_checks, 32),
        (8, layout.n_checks, 32),
        (8, layout.n_checks, 32),
        (8, layout.n_vars, 32),
        (8, layout.n_vars, 32),
        (2, 128),
        (2, 2),
    ]
    assert [x.dtype for x in scratch] == [torch.float32] * 2 + [torch.int16] + [torch.float32] * 2 + [torch.int32] * 2


def test_state_launches_stay_zero_on_the_cpu_twin(qc96):
    dec = HBMFloatDecoder(qc96, "minsum", max_iters=4, batch_tile=8)
    llrs = inputs_of("normal", qc96.n_vars, 8, seed=5)
    got = dec(llrs)
    assert dec.node_state and dec.launches == dec.state_launches == 0
    assert torch.equal(bits(got.outputs), bits(float_decode_tiled(qc96, llrs, "minsum", 8, 4).outputs))
