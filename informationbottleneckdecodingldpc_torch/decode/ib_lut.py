"""Discrete Information-Bottleneck lookup-table decoder, plain PyTorch.

Port of ``decode/ib_lut.py``: the whole batch runs in lockstep. The
reference decoder's semantics are reproduced exactly:

- initial check-node pass with the iteration-0 trellis tables;
- loop while ``i_num < imax`` and the batch has not converged: VN update with
  the iteration ``i`` tables, CN update with the iteration ``i+1`` tables,
  syndrome on the VN->CN messages;
- message-alignment remaps after each node op when matching tables are
  present: VN uses ``matching_vn[i, d-1]`` (d > 1), in-loop CN uses
  ``matching_cn[i+1, d-1]``, iteration-0 CN uses ``matching_cn[0, d-1]``;
- decision mapping folds the channel plus all messages with the VN tables of
  iteration ``iters``.

Hard-decision convention: cluster ``t < T/2`` decodes bit 1.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..construct.trellis import TrellisTables
from ..ops.lut_fold import (
    cn_lut_leave_one_out,
    vector_lookup,
    vn_lut_full_fold,
    vn_lut_leave_one_out,
)
from .common import (
    DecodeResult,
    apply_per_cn_group,
    apply_per_vn_group,
    gather_node_values_per_group,
    group_planes,
    node_outputs_to_natural_order,
    run_message_passing_loop,
    unsatisfied_checks,
)
from .graph_arrays import DecodeLayout


@dataclasses.dataclass(frozen=True)
class DeviceTrellis:
    """Trellis tables as int64 tensors on one device, plus the host tables
    they came from (the fused kernel re-lays them out)."""

    t_channel: int
    t_decoder: int
    i_max: int
    device: torch.device
    cn_iter0_first: torch.Tensor  # [Tch, Tch]
    cn_iter0_rest: torch.Tensor  # [d_c_max-3, T, Tch]
    cn_rest: torch.Tensor  # [i_max-1, d_c_max-2, T, T]
    vn_first: torch.Tensor  # [i_max, Tch, T]
    vn_rest: torch.Tensor  # [i_max, d_v_max-1, T, T]
    matching_cn: torch.Tensor | None  # [i_max, d_c_max, T]
    matching_vn: torch.Tensor | None  # [i_max, d_v_max, T]
    host: TrellisTables

    @classmethod
    def from_tables(
        cls,
        t: TrellisTables,
        device: torch.device | str,
        use_matching: bool = True,
    ) -> "DeviceTrellis":
        """Carry the numpy tables (as the JAX package stores them) to port
        tensors on ``device``."""
        device = torch.device(device)
        i64 = lambda a: torch.as_tensor(
            np.asarray(a, dtype=np.int64), device=device
        )
        match = use_matching and t.has_matching
        return cls(
            t_channel=t.cardinality_t_channel,
            t_decoder=t.cardinality_t_decoder,
            i_max=t.i_max,
            device=device,
            cn_iter0_first=i64(t.cn_iter0_first),
            cn_iter0_rest=i64(t.cn_iter0_rest),
            cn_rest=i64(t.cn_rest),
            vn_first=i64(t.vn_first),
            vn_rest=i64(t.vn_rest),
            matching_cn=i64(t.matching_cn) if match else None,
            matching_vn=i64(t.matching_vn) if match else None,
            host=t,
        )


def ib_lut_decode(
    layout: DecodeLayout,
    trellis: DeviceTrellis,
    channel_clusters: torch.Tensor,
    max_iters: int | None = None,
    early_exit: bool = True,
    convergence_reduce=None,
) -> DecodeResult:
    """Decode [n_vars, batch] channel clusters on ``trellis.device``; returns
    int32 cluster outputs, the int32 iteration count and per-codeword
    unsatisfied checks (``convergence_reduce``: as in
    ``run_message_passing_loop``)."""
    imax = max_iters if max_iters is not None else trellis.i_max
    if imax > trellis.i_max:
        raise ValueError("max_iters exceeds constructed i_max")
    device = trellis.device
    idx = layout.tensors(device)
    ch = channel_clusters.to(device=device, dtype=torch.int64)
    thresh = trellis.t_decoder // 2

    cn_view0 = ch[idx.cn_edge_var]
    ch_groups = gather_node_values_per_group(layout, ch)

    def cn_pass(cn_view, luts_for_degree, match_row):
        def fold(msgs, grp):
            out = cn_lut_leave_one_out(msgs, luts_for_degree(grp.degree))
            if match_row is not None:
                out = vector_lookup(match_row[grp.degree - 1], out)
            return out

        return apply_per_cn_group(layout, cn_view, fold)[idx.to_vn_perm]

    vn_view = cn_pass(
        cn_view0,
        lambda d: [trellis.cn_iter0_first]
        + [trellis.cn_iter0_rest[l] for l in range(d - 3)],
        trellis.matching_cn[0] if trellis.matching_cn is not None else None,
    )

    def body(state, i):
        (vn_view,) = state
        vn_first_i, vn_rest_i = trellis.vn_first[i], trellis.vn_rest[i]
        match_vn_i = (
            trellis.matching_vn[i] if trellis.matching_vn is not None else None
        )

        def fold(chv, msgs, grp):
            d = grp.degree
            out = vn_lut_leave_one_out(
                chv, msgs, vn_first_i, [vn_rest_i[l] for l in range(max(d - 2, 0))]
            )
            if match_vn_i is not None and d > 1:
                out = vector_lookup(match_vn_i[d - 1], out)
            return out

        cn_view = apply_per_vn_group(layout, vn_view, ch_groups, fold)[
            idx.to_cn_perm
        ]

        cn_rest_i = trellis.cn_rest[i]
        new_vn_view = cn_pass(
            cn_view,
            lambda d: [cn_rest_i[l] for l in range(d - 2)],
            trellis.matching_cn[i + 1]
            if trellis.matching_cn is not None
            else None,
        )
        unsat = unsatisfied_checks(layout, cn_view < thresh)
        return (new_vn_view,), unsat

    (vn_view,), iters, unsat = run_message_passing_loop(
        (vn_view,),
        body,
        max_inner_iters=imax - 1,
        batch=ch.shape[-1],
        device=device,
        early_exit=early_exit,
        convergence_reduce=convergence_reduce,
    )

    # Decision mapping with the VN tables of iteration ``iters``.
    it = int(iters)
    dec_first, dec_rest = trellis.vn_first[it], trellis.vn_rest[it]
    outs = []
    for grp, chv in zip(layout.vn_groups, ch_groups):
        outs.append(
            vn_lut_full_fold(
                chv,
                group_planes(vn_view, grp),
                dec_first,
                [dec_rest[l] for l in range(max(grp.degree - 1, 0))],
            )
        )
    outputs = node_outputs_to_natural_order(layout, outs)
    return DecodeResult(
        outputs=outputs.to(torch.int32), iterations=iters, unsatisfied=unsat
    )
