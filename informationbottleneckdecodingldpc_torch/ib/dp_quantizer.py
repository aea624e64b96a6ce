"""Exact symmetric information-bottleneck quantizer via dynamic programming.

The reference relies on the external ib_base package's ``symmetric_sIB`` /
``lin_sym_sIB`` — randomized sequential-IB local search with ``nror`` restarts
producing a *deterministic, symmetric* clustering of a binary-input joint pmf
(Discrete_Density_Evolution.py:138-145, AWGN_Quantizer_BPSK.py:81-85).

This module computes the *globally optimal* such clustering instead: for a
binary-input pmf, an MI-maximizing deterministic quantizer uses quantization
regions that are contiguous in LLR order (Kurkoski & Yagi, "Quantization of
Binary-Input Discrete Memoryless Channels", IEEE Trans. IT 2014), so the
optimum over symmetric contiguous partitions is found exactly by DP over
cluster boundaries on the sorted-LLR half-domain. Deterministic, no restarts,
and its I(X;T) upper-bounds any sequential-IB solution — so decoders built on
it match or beat the reference construction.

Cluster-label convention (required by the decoder's hard decisions and the
channel quantizer, see SURVEY.md §3.2): labels ascend with LLR
``log p(x=0|y)/p(x=1|y)``; label ``t`` and ``K-1-t`` are mirror images; bit
decision is ``t < K/2  <=>  bit 1``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

_LOG_EPS = 1e-300


def partial_mi_table(cum0: np.ndarray, cum1: np.ndarray) -> np.ndarray:
    """g[a, b] = partial mutual information of interval [a, b) in bits.

    ``cum0/cum1`` are prefix sums (length M+1) of p(x=0, y) / p(x=1, y) over
    sorted outputs. Assumes uniform prior p(x) = 1/2 (all pipelines here are
    symmetric-binary). Entries with a >= b are 0.
    """
    s0 = cum0[None, :] - cum0[:, None]
    s1 = cum1[None, :] - cum1[:, None]
    st = s0 + s1
    with np.errstate(divide="ignore", invalid="ignore"):
        t0 = np.where(s0 > 0, s0 * np.log2(np.maximum(s0, _LOG_EPS) / np.maximum(0.5 * st, _LOG_EPS)), 0.0)
        t1 = np.where(s1 > 0, s1 * np.log2(np.maximum(s1, _LOG_EPS) / np.maximum(0.5 * st, _LOG_EPS)), 0.0)
    g = t0 + t1
    # Empty or inverted intervals are forbidden (forces K non-empty clusters).
    m = cum0.shape[0]
    a_idx = np.arange(m)[:, None]
    b_idx = np.arange(m)[None, :]
    return np.where(a_idx < b_idx, g, -np.inf)


@dataclasses.dataclass(frozen=True)
class QuantizerResult:
    """Deterministic quantizer p(t|y) with derived statistics.

    ``labels[y]`` is the cluster of output y **in the original input order**;
    ``p_t_given_y`` is its one-hot form, matching ib_base's ``get_results()``
    tuple ``(p_t_given_y, p_x_given_t, p_t)``.
    """

    labels: np.ndarray  # [Y] int32
    p_t_given_y: np.ndarray  # [Y, K] float64 one-hot
    p_x_given_t: np.ndarray  # [K, 2]
    p_t: np.ndarray  # [K]
    mi_xt: float
    mi_xy: float


def optimal_symmetric_quantizer(
    p_xy: np.ndarray, cardinality_t: int, symmetrize: bool = True
) -> QuantizerResult:
    """Globally optimal symmetric deterministic quantizer of a binary joint.

    Args:
      p_xy: [Y, 2] joint pmf, columns are x=0 and x=1. Y and cardinality_t
        must be even. The pmf is expected to be (numerically close to)
        symmetric: mirroring y (by LLR rank) and flipping x leaves it
        invariant; ``symmetrize`` enforces this exactly before the DP.
      cardinality_t: number K of clusters.

    Returns: QuantizerResult with labels ascending in LLR.
    """
    p = np.asarray(p_xy, dtype=np.float64)
    if p.ndim != 2 or p.shape[1] != 2:
        raise ValueError("p_xy must be [Y, 2]")
    Y = p.shape[0]
    K = int(cardinality_t)
    if Y % 2 or K % 2:
        raise ValueError("Y and cardinality_t must be even")
    if K > Y:
        raise ValueError("more clusters than outputs")
    p = p / p.sum()

    # Sort by LLR ascending (most-confident bit-1 first). Stable sort plus a
    # deterministic tiebreak on index keeps mirror pairs aligned.
    with np.errstate(divide="ignore"):
        llr = np.log(np.maximum(p[:, 0], _LOG_EPS)) - np.log(
            np.maximum(p[:, 1], _LOG_EPS)
        )
    order = np.argsort(llr, kind="stable")
    ps = p[order]

    if symmetrize:
        ps = 0.5 * (ps + ps[::-1, ::-1])

    half = Y // 2
    kh = K // 2
    cum0 = np.concatenate([[0.0], np.cumsum(ps[:half, 0])])
    cum1 = np.concatenate([[0.0], np.cumsum(ps[:half, 1])])
    g = partial_mi_table(cum0, cum1)

    # dp[k, b]: best sum of partial MIs for splitting [0, b) into k clusters.
    neg = -np.inf
    dp = np.full((kh + 1, half + 1), neg)
    back = np.zeros((kh + 1, half + 1), dtype=np.int64)
    dp[0, 0] = 0.0
    for k in range(1, kh + 1):
        # candidate predecessor boundaries a in [k-1, half-(kh-k)-1]
        cand = dp[k - 1][:, None] + g
        best_a = np.argmax(cand, axis=0)
        dp[k] = cand[best_a, np.arange(half + 1)]
        back[k] = best_a

    # Backtrack the boundaries 0 = b_0 < ... < b_kh = half.
    bounds = np.empty(kh + 1, dtype=np.int64)
    bounds[kh] = half
    for k in range(kh, 0, -1):
        bounds[k - 1] = back[k, bounds[k]]

    labels_sorted = np.empty(Y, dtype=np.int32)
    for k in range(kh):
        labels_sorted[bounds[k] : bounds[k + 1]] = k
    labels_sorted[half:] = K - 1 - labels_sorted[:half][::-1]

    labels = np.empty(Y, dtype=np.int32)
    labels[order] = labels_sorted

    p_t_given_y = np.zeros((Y, K))
    p_t_given_y[np.arange(Y), labels] = 1.0
    p_x_and_t = p_t_given_y.T @ p  # [K, 2]
    p_t = p_x_and_t.sum(axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        p_x_given_t = np.where(p_t[:, None] > 0, p_x_and_t / np.maximum(p_t, _LOG_EPS)[:, None], 0.5)

    from .tools import mutual_information

    return QuantizerResult(
        labels=labels,
        p_t_given_y=p_t_given_y,
        p_x_given_t=p_x_given_t,
        p_t=p_t,
        mi_xt=mutual_information(p_x_and_t),
        mi_xy=mutual_information(p),
    )
