"""Leave-one-out trellis-LUT folds (the discrete decoder's node operations).

Port of ``ops/lut_fold.py`` with direct ``lut[a, b]`` indexing: on the GPU
the tables are small gathers (in the Hopper kernel, shared-memory reads), so
the JAX package's packed-column compare-select machinery, a TPU workaround,
is not ported.

Semantics contract (the reference trellis layout): a node op folds its input
sequence strictly left to right through per-step pairwise LUTs, each indexed
``lut[state, next]``; the output for edge j folds the sequence with element j
removed, using steps 0..d-3 in order. The chains share their full-sequence
prefixes, as in the JAX package (about d^2/2 lookups per node).

Messages are int64 tensors (torch indexes with int64): a node group's
inputs are d planes of [n, batch] (a [d, n, batch] tensor), and its outputs
come back as one [d, n, batch] tensor.
"""

from __future__ import annotations

import torch


def vector_lookup(row: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out = row[idx] for a 1-D LUT ``row`` (message-alignment remaps)."""
    return row[idx]


def cn_lut_leave_one_out(msgs, step_luts: list[torch.Tensor]):
    """Check-node trellis update for one degree group.

    ``step_luts``: d-2 pairwise LUTs (step 0 combines the first two
    messages). Output plane j is the fold of every message except j."""
    m = list(msgs)
    d = len(m)
    if d == 2:
        return torch.stack([m[1], m[0]])
    outs: list = [None] * d
    # Prefixes f[k] = fold(m_0..m_k), k = 1..d-2.
    f: list = [None, step_luts[0][m[0], m[1]]]
    for k in range(2, d - 1):
        f.append(step_luts[k - 1][f[k - 1], m[k]])
    # Output j >= 2 continues prefix f[j-1]; message k then sits at
    # position k-1 and takes LUT k-2.
    for j in range(2, d):
        s = f[j - 1]
        for k in range(j + 1, d):
            s = step_luts[k - 2][s, m[k]]
        outs[j] = s
    s0 = step_luts[0][m[1], m[2]]
    s1 = step_luts[0][m[0], m[2]]
    for k in range(3, d):
        s0 = step_luts[k - 2][s0, m[k]]
        s1 = step_luts[k - 2][s1, m[k]]
    outs[0], outs[1] = s0, s1
    return torch.stack(outs)


def vn_lut_leave_one_out(
    ch: torch.Tensor, msgs, first_lut: torch.Tensor, rest_luts: list
):
    """Variable-node trellis update for one degree group.

    Output plane j folds (ch, every message except j): the first step uses
    ``first_lut[ch, msg]``, step p >= 1 uses ``rest_luts[p-1]``. Degree-1
    nodes forward the channel value."""
    m = list(msgs)
    d = len(m)
    if d == 1:
        return ch[None]
    luts = [first_lut] + list(rest_luts)
    outs: list = [None] * d
    # Prefixes f[k] = fold(ch, m_0..m_k); message k (k >= 1) takes LUT k.
    f = [luts[0][ch, m[0]]]
    for k in range(1, d - 1):
        f.append(luts[k][f[k - 1], m[k]])
    # Output j continues f[j-1]; message k then takes LUT k-1.
    for j in range(1, d):
        s = f[j - 1]
        for k in range(j + 1, d):
            s = luts[k - 1][s, m[k]]
        outs[j] = s
    s0 = luts[0][ch, m[1]]
    for k in range(2, d):
        s0 = luts[k - 1][s0, m[k]]
    outs[0] = s0
    return torch.stack(outs)


def vn_lut_full_fold(
    ch: torch.Tensor, msgs, first_lut: torch.Tensor, rest_luts: list
) -> torch.Tensor:
    """Decision mapping: fold the channel plus all d messages."""
    m = list(msgs)
    s = first_lut[ch, m[0]]
    for k in range(1, len(m)):
        s = rest_luts[k - 1][s, m[k]]
    return s
