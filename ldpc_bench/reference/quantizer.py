"""The channel quantizer for BPSK over AWGN: tables and per-sample operations.

A frozen copy of the construction the system under test states: the
received value y is read on a grid of ``cardinality_y`` points over
[-ad_max_abs, ad_max_abs], p(y | x = 0) is the Gaussian at +1 with the
clipped tails folded into the border cells, and the grid is split into
``cardinality_t`` clusters by the globally optimal symmetric deterministic
quantizer (dynamic programming over contiguous regions in LLR order,
Kurkoski and Yagi, IEEE Trans. IT 2014). From it come the cluster borders
``limits`` (``limits[T/2] = 0``), the cdf of p(t | x = 0) for inversion
sampling and each cluster's LLR, all as float32.

A cluster is the number of thresholds strictly below the value: ``limits[1:]``
for a received y, ``cdf[1:-1]`` for a uniform; label t < T/2 decides bit 1.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.stats import norm

_LOG_EPS = 1e-300


def sigma2_from_ebn0_db(ebn0_db: float, code_rate: float) -> float:
    """sigma^2 = 10^(-Eb/N0 / 10) / (2 R)."""
    return 10.0 ** (-ebn0_db / 10.0) / (2.0 * code_rate)


def _partial_mi(cum0: np.ndarray, cum1: np.ndarray) -> np.ndarray:
    """g[a, b]: partial mutual information of the interval [a, b) in bits,
    -inf where a >= b."""
    s0 = cum0[None, :] - cum0[:, None]
    s1 = cum1[None, :] - cum1[:, None]
    st = s0 + s1
    with np.errstate(divide="ignore", invalid="ignore"):
        t0 = np.where(s0 > 0, s0 * np.log2(np.maximum(s0, _LOG_EPS) / np.maximum(0.5 * st, _LOG_EPS)), 0.0)
        t1 = np.where(s1 > 0, s1 * np.log2(np.maximum(s1, _LOG_EPS) / np.maximum(0.5 * st, _LOG_EPS)), 0.0)
    m = cum0.shape[0]
    return np.where(np.arange(m)[:, None] < np.arange(m)[None, :], t0 + t1, -np.inf)


def _symmetric_quantizer(p: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Labels (ascending in LLR) of the optimal symmetric quantizer of the
    joint pmf ``p`` [Y, 2] into ``k`` clusters, and the joint p(x, t) [k, 2]."""
    p = p / p.sum()
    y = p.shape[0]
    with np.errstate(divide="ignore"):
        llr = np.log(np.maximum(p[:, 0], _LOG_EPS)) - np.log(np.maximum(p[:, 1], _LOG_EPS))
    order = np.argsort(llr, kind="stable")
    ps = p[order]
    ps = 0.5 * (ps + ps[::-1, ::-1])
    half, kh = y // 2, k // 2
    cum0 = np.concatenate([[0.0], np.cumsum(ps[:half, 0])])
    cum1 = np.concatenate([[0.0], np.cumsum(ps[:half, 1])])
    g = _partial_mi(cum0, cum1)
    dp = np.full((kh + 1, half + 1), -np.inf)
    back = np.zeros((kh + 1, half + 1), dtype=np.int64)
    dp[0, 0] = 0.0
    for j in range(1, kh + 1):
        cand = dp[j - 1][:, None] + g
        best = np.argmax(cand, axis=0)
        dp[j] = cand[best, np.arange(half + 1)]
        back[j] = best
    bounds = np.empty(kh + 1, dtype=np.int64)
    bounds[kh] = half
    for j in range(kh, 0, -1):
        bounds[j - 1] = back[j, bounds[j]]
    sorted_labels = np.empty(y, dtype=np.int32)
    for j in range(kh):
        sorted_labels[bounds[j]:bounds[j + 1]] = j
    sorted_labels[half:] = k - 1 - sorted_labels[:half][::-1]
    labels = np.empty(y, dtype=np.int32)
    labels[order] = sorted_labels
    one_hot = np.zeros((y, k))
    one_hot[np.arange(y), labels] = 1.0
    return labels, one_hot.T @ p


def tables(sigma2: float, ad_max_abs: float, cardinality_t: int,
           cardinality_y: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(limits [T], cdf of p(t | x = 0) [T + 1], each cluster's LLR [T]) as
    float32."""
    y_vec = np.linspace(-ad_max_abs, ad_max_abs, cardinality_y)
    delta = y_vec[1] - y_vec[0]
    sigma = np.sqrt(sigma2)
    p0 = norm.pdf(y_vec, loc=1.0, scale=sigma) * delta
    p0[-1] += norm.sf((ad_max_abs - 1.0 + delta / 2) / sigma)
    p0[0] += 1.0 - norm.sf((-ad_max_abs - delta - 1.0 + delta / 2) / sigma)
    p_xy = 0.5 * np.stack([p0, p0[::-1]], axis=1)
    labels, p_x_and_t = _symmetric_quantizer(p_xy / p_xy.sum(), cardinality_t)
    p_t = p_x_and_t.sum(axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        p_x_given_t = np.where(p_t[:, None] > 0, p_x_and_t / np.maximum(p_t, _LOG_EPS)[:, None], 0.5)
    p_x_given_t = p_x_given_t / p_x_given_t.sum(axis=1, keepdims=True)
    joint = p_x_given_t * p_t[:, None]
    cdf = np.concatenate([[0.0], np.cumsum(joint[:, 0] / 0.5)])
    cdf[-1] = max(cdf[-1], 1.0)
    with np.errstate(divide="ignore"):
        llrs = np.log(joint[:, 0]) - np.log(joint[:, 1])
    limits = np.array([y_vec[np.nonzero(labels == t)[0].min()] for t in range(cardinality_t)])
    limits[cardinality_t // 2] = 0.0
    return limits.astype(np.float32), cdf.astype(np.float32), llrs.astype(np.float32)


def count_below(thresholds: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """int32 count of ``thresholds`` strictly below each element of ``x``."""
    out = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    for t in thresholds:
        out += (x > t).to(torch.int32)
    return out
