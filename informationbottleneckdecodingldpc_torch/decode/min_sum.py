"""Min-sum decoder, plain PyTorch (port of ``decode/min_sum.py``)."""

from __future__ import annotations

import torch

from ..ops.float_ops import cn_minsum_leave_one_out
from .common import DecodeResult
from .float_common import float_decode
from .graph_arrays import DecodeLayout


def min_sum_decode(
    layout: DecodeLayout,
    channel_llrs: torch.Tensor,
    max_iters: int,
    early_exit: bool = True,
    convergence_reduce=None,
) -> DecodeResult:
    """Decode [n_vars, batch] channel LLRs with the min-sum rule
    (``convergence_reduce``: as in ``run_message_passing_loop``)."""
    return float_decode(
        layout,
        channel_llrs,
        max_iters,
        cn_update=lambda msgs, grp: cn_minsum_leave_one_out(msgs),
        early_exit=early_exit,
        convergence_reduce=convergence_reduce,
    )
