"""Shared decoder plumbing: result type, syndrome and the iteration loop.

Port of ``decode/common.py``. The loop rule is the reference's: run while
``i_num < imax`` and the whole batch has not converged, that is at most
``imax - 1`` in-loop bodies with the whole batch in lockstep.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from .graph_arrays import DecodeLayout


@dataclasses.dataclass
class DecodeResult:
    """Decoder output.

    ``outputs``: [n_vars, batch] int32 cluster index in natural variable
    order. ``iterations``: the executed in-loop iteration count; an int32
    scalar for the whole-batch decoder, and the float32 per-codeword mean for
    the tiled decoders (each tile of codewords exits on its own).
    ``unsatisfied``: [batch] int32 unsatisfied-check count at exit.
    """

    outputs: torch.Tensor
    iterations: torch.Tensor
    unsatisfied: torch.Tensor


def unsatisfied_checks(
    layout: DecodeLayout, cn_view_bits: torch.Tensor
) -> torch.Tensor:
    """Per-codeword count of unsatisfied checks from hard bits in CN view:
    the syndrome of a check is the XOR of its incoming messages' bits."""
    batch = cn_view_bits.shape[-1]
    total = torch.zeros(batch, dtype=torch.int32, device=cn_view_bits.device)
    for grp in layout.cn_groups:
        n = grp.num_nodes
        parity = cn_view_bits[grp.offset : grp.offset + n]
        for j in range(1, grp.degree):
            off = grp.offset + j * n
            parity = parity ^ cn_view_bits[off : off + n]
        total += parity.sum(dim=0, dtype=torch.int32)
    return total


def run_message_passing_loop(
    init_state: Any,
    body: Callable[[Any, int], tuple[Any, torch.Tensor]],
    max_inner_iters: int,
    batch: int,
    device: torch.device | str,
    early_exit: bool = True,
):
    """Run ``body(state, i) -> (state, unsatisfied_per_codeword)`` at most
    ``max_inner_iters`` times, stopping early (when ``early_exit``) once no
    codeword has an unsatisfied check. The convergence test reads the count
    back to the host after each body.

    Returns (final_state, iterations_run as an int32 scalar tensor,
    last unsatisfied counts, all ones if no body ran)."""
    state = init_state
    unsat = torch.ones(batch, dtype=torch.int32, device=device)
    i = 0
    while i < max_inner_iters:
        state, unsat = body(state, i)
        i += 1
        if early_exit and not bool((unsat > 0).any()):
            break
    return state, torch.tensor(i, dtype=torch.int32, device=device), unsat
