"""Float message-passing primitives for the BP and min-sum decoders.

Port of ``ops/float_ops.py``. LLRs are clamped at +/-``LLR_MAX`` at the
variable-node outputs; the check-node box-plus never exceeds the magnitude of
its smallest input, so prefix/suffix evaluation needs no clamp. Every fold
keeps the JAX package's order, so min-sum and the sums round identically
(min-sum up to the sign of a zero); box-plus goes through ``exp``/``log1p``,
whose last bits differ between libraries.
"""

from __future__ import annotations

from typing import Callable

import torch

LLR_MAX = 150.0


def boxplus(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Stable log-domain box-plus, 2 atanh(tanh(a/2) tanh(b/2)):
    sign(a)sign(b)min(|a|,|b|) + log1p-correction terms."""
    sgn = torch.sign(a) * torch.sign(b)
    mag = torch.minimum(a.abs(), b.abs())
    corr = torch.log1p(torch.exp(-(a + b).abs())) - torch.log1p(
        torch.exp(-(a - b).abs())
    )
    return sgn * mag + corr


def min_sum_op(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sign(a b) min(|a|, |b|); sign(0) = 0."""
    return torch.sign(a) * torch.sign(b) * torch.minimum(a.abs(), b.abs())


def associative_leave_one_out(
    op: Callable[[torch.Tensor, torch.Tensor], torch.Tensor], msgs: torch.Tensor
) -> torch.Tensor:
    """Leave-one-out fold of an associative op over axis 0 via prefix/suffix.

    msgs: [d, n, batch] slot-major planes; output plane j combines every
    message but j."""
    d = msgs.shape[0]
    if d == 1:
        raise ValueError("leave-one-out undefined for degree-1 check nodes")
    if d == 2:
        return torch.stack([msgs[1], msgs[0]], dim=0)
    prefix = [msgs[0]]
    for k in range(1, d - 1):
        prefix.append(op(prefix[-1], msgs[k]))
    suffix = [msgs[d - 1]]
    for k in range(d - 2, 0, -1):
        suffix.append(op(msgs[k], suffix[-1]))
    suffix.reverse()  # suffix[k-1] = fold(m_k..m_{d-1})
    outs = [suffix[0]]
    for j in range(1, d - 1):
        outs.append(op(prefix[j - 1], suffix[j]))
    outs.append(prefix[d - 2])
    return torch.stack(outs, dim=0)


def cn_boxplus_leave_one_out(msgs: torch.Tensor) -> torch.Tensor:
    """BP check-node update."""
    return associative_leave_one_out(boxplus, msgs)


def cn_minsum_leave_one_out(msgs: torch.Tensor) -> torch.Tensor:
    """Min-sum check-node update."""
    return associative_leave_one_out(min_sum_op, msgs)


def sum_planes(msgs: torch.Tensor) -> torch.Tensor:
    """Strict left-fold sum over axis 0, ((m0 + m1) + m2) + ..."""
    s = msgs[0]
    for k in range(1, msgs.shape[0]):
        s = s + msgs[k]
    return s


def vn_sum_leave_one_out(ch: torch.Tensor, msgs: torch.Tensor) -> torch.Tensor:
    """Variable-node update: channel + sum of the other messages, clamped to
    +/-LLR_MAX. msgs is [d, n, batch]; degree-1 nodes forward the clamped
    channel LLR."""
    if msgs.shape[0] == 1:
        return torch.clamp(ch[None], -LLR_MAX, LLR_MAX)
    total = (ch + sum_planes(msgs))[None]
    return torch.clamp(total - msgs, -LLR_MAX, LLR_MAX)


def minsum_leave_one_out_planes(planes: list) -> list:
    """Min-sum leave-one-out over a list of planes via min1/min2 and
    leave-one-out sign products. Equal (``==``) to the pairwise
    ``min_sum_op`` fold; only the sign of a zero may differ."""
    d = len(planes)
    if d == 1:
        raise ValueError("leave-one-out undefined for degree-1 check nodes")
    if d == 2:
        return [planes[1], planes[0]]
    mags = [p.abs() for p in planes]
    sgns = [torch.sign(p) for p in planes]
    # min1 = smallest magnitude, min2 = second smallest (== min1 on ties).
    min1 = mags[0]
    min2 = torch.full_like(mags[0], float("inf"))
    for a in mags[1:]:
        min2 = torch.minimum(min2, torch.maximum(min1, a))
        min1 = torch.minimum(min1, a)
    # Leave-one-out sign products via prefix/suffix (zeros propagate).
    pre = [sgns[0]]
    for k in range(1, d - 1):
        pre.append(pre[-1] * sgns[k])
    suf = [sgns[-1]]
    for k in range(d - 2, 0, -1):
        suf.insert(0, sgns[k] * suf[0])
    out = []
    for j in range(d):
        if j == 0:
            s = suf[0]
        elif j == d - 1:
            s = pre[d - 2]
        else:
            s = pre[j - 1] * suf[j]
        out.append(s * torch.where(mags[j] == min1, min2, min1))
    return out
