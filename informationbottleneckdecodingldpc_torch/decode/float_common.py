"""Shared driver of the float (BP and min-sum) decoders, plain PyTorch.

Port of ``decode/float_common.py``: the two decoders share one loop shape and
differ only in the check-node rule. The CN view is seeded with the channel
LLRs; each body runs CN update -> route -> VN update -> route -> syndrome of
the new CN view (hard bit ``llr < 0``), at most ``max_iters - 1`` bodies with
the whole batch in lockstep. The decision is the channel LLR plus the
left-fold sum of all incoming messages, unclamped.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..ops.float_ops import sum_planes, vn_sum_leave_one_out
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


def float_decode(
    layout: DecodeLayout,
    channel_llrs: torch.Tensor,
    max_iters: int,
    cn_update: Callable,
    early_exit: bool = True,
    convergence_reduce: Callable | None = None,
) -> DecodeResult:
    """Decode [n_vars, batch] channel LLRs on their device with the check
    rule ``cn_update(msgs[d, n, batch], group)``; float32 posterior LLRs,
    the int32 iteration count and per-codeword unsatisfied checks.
    ``convergence_reduce``: as in :func:`run_message_passing_loop`."""
    device = channel_llrs.device
    idx = layout.tensors(device)
    llrs = channel_llrs.to(torch.float32)
    cn_view0 = llrs[idx.cn_edge_var]
    vn_view0 = torch.zeros_like(cn_view0)
    llr_groups = gather_node_values_per_group(layout, llrs)

    def body(state, _i):
        cn_view, _ = state
        vn_view = apply_per_cn_group(layout, cn_view, cn_update)[idx.to_vn_perm]
        vn_out = apply_per_vn_group(
            layout, vn_view, llr_groups,
            lambda ch, msgs, grp: vn_sum_leave_one_out(ch, msgs),
        )
        new_cn_view = vn_out[idx.to_cn_perm]
        return (new_cn_view, vn_view), unsatisfied_checks(layout, new_cn_view < 0)

    (cn_view, vn_view), iters, _ = run_message_passing_loop(
        (cn_view0, vn_view0),
        body,
        max_inner_iters=max_iters - 1,
        batch=llrs.shape[-1],
        device=device,
        early_exit=early_exit,
        convergence_reduce=convergence_reduce,
    )
    outs = [
        ch + sum_planes(group_planes(vn_view, grp))
        for grp, ch in zip(layout.vn_groups, llr_groups)
    ]
    return DecodeResult(
        outputs=node_outputs_to_natural_order(layout, outs),
        iterations=iters,
        unsatisfied=unsatisfied_checks(layout, cn_view < 0),
    )
