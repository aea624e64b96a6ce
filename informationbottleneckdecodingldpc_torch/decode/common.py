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

    ``outputs``: [n_vars, batch] in natural variable order: the int32
    cluster index for the IB decoder, the float32 posterior LLR for min-sum
    and BP. ``iterations``: the executed in-loop iteration count; an int32
    scalar for the whole-batch decoder, and the float32 per-codeword mean for
    the tiled decoders (each tile of codewords exits on its own).
    ``unsatisfied``: [batch] int32 unsatisfied-check count at exit.
    """

    outputs: torch.Tensor
    iterations: torch.Tensor
    unsatisfied: torch.Tensor


def group_planes(view: torch.Tensor, grp) -> torch.Tensor:
    """A degree group's rows of a view as [degree, num_nodes, batch]."""
    size = grp.num_nodes * grp.degree
    return view[grp.offset : grp.offset + size].reshape(
        grp.degree, grp.num_nodes, -1
    )


def apply_per_cn_group(
    layout: DecodeLayout, edge_array: torch.Tensor, fn: Callable
) -> torch.Tensor:
    """Apply fn(msgs[d, n, batch], group) -> [d, n, batch] over each
    check-node degree group; the results in CN-view row order."""
    batch = edge_array.shape[-1]
    return torch.cat(
        [
            fn(group_planes(edge_array, grp), grp).reshape(-1, batch)
            for grp in layout.cn_groups
        ],
        dim=0,
    )


def gather_node_values_per_group(
    layout: DecodeLayout, node_values: torch.Tensor
) -> list[torch.Tensor]:
    """Per-VN-group node values ([num_nodes, batch] each, group order),
    gathered once from [n_vars, batch] (e.g. the channel values)."""
    ordered = node_values[layout.tensors(node_values.device).vn_node_order]
    return list(torch.split(ordered, [g.num_nodes for g in layout.vn_groups]))


def apply_per_vn_group(
    layout: DecodeLayout,
    edge_array: torch.Tensor,
    node_values_per_group: list[torch.Tensor],
    fn: Callable,
) -> torch.Tensor:
    """Apply fn(ch[n, batch], msgs[d, n, batch], group) -> [d, n, batch]
    over each variable-node degree group; the results in VN-view row
    order."""
    batch = edge_array.shape[-1]
    return torch.cat(
        [
            fn(ch, group_planes(edge_array, grp), grp).reshape(-1, batch)
            for grp, ch in zip(layout.vn_groups, node_values_per_group)
        ],
        dim=0,
    )


def node_outputs_to_natural_order(
    layout: DecodeLayout, per_group_outputs: list[torch.Tensor]
) -> torch.Tensor:
    """Concatenate per-VN-group node results and restore variable order."""
    concat = torch.cat(per_group_outputs, dim=0)
    return concat[layout.tensors(concat.device).vn_node_unperm]


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
    convergence_reduce: Callable[[torch.Tensor], torch.Tensor] | None = None,
):
    """Run ``body(state, i) -> (state, unsatisfied_per_codeword)`` at most
    ``max_inner_iters`` times, stopping early (when ``early_exit``) once no
    codeword has an unsatisfied check. The convergence test reads the count
    back to the host after each body. ``convergence_reduce`` maps the
    per-codeword unconverged flags (int32) to a count, which must be 0 to
    stop; the data-parallel engine passes one that sums over every rank
    (``parallel.psum_convergence_reduce``), so all ranks stop together.

    Returns (final_state, iterations_run as an int32 scalar tensor,
    last unsatisfied counts, all ones if no body ran)."""
    reduce = convergence_reduce or (lambda u: u.sum())
    state = init_state
    unsat = torch.ones(batch, dtype=torch.int32, device=device)
    i = 0
    while i < max_inner_iters:
        state, unsat = body(state, i)
        i += 1
        if early_exit and not bool(reduce((unsat > 0).to(torch.int32)) > 0):
            break
    return state, torch.tensor(i, dtype=torch.int32, device=device), unsat
