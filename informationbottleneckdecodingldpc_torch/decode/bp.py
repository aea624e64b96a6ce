"""Belief-propagation decoder, plain PyTorch (port of ``decode/bp.py``): the
min-sum loop with the box-plus check-node rule."""

from __future__ import annotations

import torch

from ..ops.float_ops import cn_boxplus_leave_one_out
from .common import DecodeResult
from .float_common import float_decode
from .graph_arrays import DecodeLayout


def belief_propagation_decode(
    layout: DecodeLayout,
    channel_llrs: torch.Tensor,
    max_iters: int,
    early_exit: bool = True,
    convergence_reduce=None,
) -> DecodeResult:
    """Decode [n_vars, batch] channel LLRs with sum-product (box-plus) BP
    (``convergence_reduce``: as in ``run_message_passing_loop``)."""
    return float_decode(
        layout,
        channel_llrs,
        max_iters,
        cn_update=lambda msgs, grp: cn_boxplus_leave_one_out(msgs),
        early_exit=early_exit,
        convergence_reduce=convergence_reduce,
    )
