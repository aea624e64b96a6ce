"""Symmetric sequential information bottleneck (API-compatible classes).

The reference constructs decoders through ib_base's classes
``symmetric_sIB(p_xy, K, nror)`` (channel quantizer,
AWGN_Quantizer_BPSK.py:81-85) and ``lin_sym_sIB(p_joint, K, nror)`` (density
evolution, Discrete_Density_Evolution.py:138-145), both exposing
``run_IB_algo()``, ``get_results() -> (p_t_given_y, p_x_given_t, p_t)``,
``get_mutual_inf() -> (I(X;T), I(X;Y))`` and ``display_MIs(short=...)``.

Here both classes are backed by the exact DP solver
(:mod:`.dp_quantizer`), which dominates randomized sequential IB; the
classic randomized algorithm is kept as :func:`sequential_sib` for
property tests (DP result must always achieve >= its I(X;T)).
"""

from __future__ import annotations

import numpy as np

from .dp_quantizer import optimal_symmetric_quantizer, QuantizerResult
from .tools import mutual_information


class SymmetricSIB:
    """Deterministic symmetric IB clustering of a binary-input joint pmf.

    Drop-in equivalent of ib_base's ``symmetric_sIB``. ``nror`` is accepted
    for interface parity; the DP solver is exact so restarts are unnecessary.
    """

    def __init__(self, p_xy: np.ndarray, cardinality_t: int, nror: int = 1):
        self.p_xy = np.asarray(p_xy, dtype=np.float64)
        self.cardinality_t = int(cardinality_t)
        self.nror = int(nror)
        self._result: QuantizerResult | None = None

    def run_IB_algo(self) -> None:
        self._result = optimal_symmetric_quantizer(self.p_xy, self.cardinality_t)

    @property
    def result(self) -> QuantizerResult:
        if self._result is None:
            self.run_IB_algo()
        return self._result

    def get_results(self):
        r = self.result
        return r.p_t_given_y, r.p_x_given_t, r.p_t

    def get_mutual_inf(self):
        r = self.result
        return r.mi_xt, r.mi_xy

    def display_MIs(self, short: bool = False) -> None:
        mi_xt, mi_xy = self.get_mutual_inf()
        if short:
            print(f"I(X;T)={mi_xt:.6f}  I(X;Y)={mi_xy:.6f}")
        else:
            print(
                f"MI: I(X;T)={mi_xt:.6f}, I(X;Y)={mi_xy:.6f}, "
                f"ratio={mi_xt / max(mi_xy, 1e-300):.6f}"
            )


class LinSymSIB(SymmetricSIB):
    """Equivalent of ib_base's ``lin_sym_sIB``: symmetric clustering with
    clusters contiguous in LLR order ("linear"). Identical engine — the DP
    already optimizes over exactly that family."""


def sequential_sib(
    p_xy: np.ndarray,
    cardinality_t: int,
    nror: int = 5,
    seed: int = 0,
    max_sweeps: int = 60,
) -> QuantizerResult:
    """Classic randomized symmetric sequential IB (for cross-checks).

    Random symmetric contiguous boundary init in sorted-LLR space, then
    greedy boundary moves until convergence; best of ``nror`` restarts.
    """
    p = np.asarray(p_xy, dtype=np.float64)
    p = p / p.sum()
    Y, K = p.shape[0], int(cardinality_t)
    if Y % 2 or K % 2:
        raise ValueError("Y and cardinality_t must be even")
    with np.errstate(divide="ignore"):
        llr = np.log(np.maximum(p[:, 0], 1e-300)) - np.log(np.maximum(p[:, 1], 1e-300))
    order = np.argsort(llr, kind="stable")
    ps = p[order]
    ps = 0.5 * (ps + ps[::-1, ::-1])
    half, kh = Y // 2, K // 2
    cum0 = np.concatenate([[0.0], np.cumsum(ps[:half, 0])])
    cum1 = np.concatenate([[0.0], np.cumsum(ps[:half, 1])])

    def interval_mi(a: int, b: int) -> float:
        s0 = cum0[b] - cum0[a]
        s1 = cum1[b] - cum1[a]
        st = s0 + s1
        out = 0.0
        for s in (s0, s1):
            if s > 0:
                out += s * np.log2(s / (0.5 * st))
        return out

    rng = np.random.default_rng(seed)
    best_bounds, best_mi = None, -np.inf
    for _ in range(max(1, nror)):
        interior = np.sort(rng.choice(np.arange(1, half), size=kh - 1, replace=False)) if kh > 1 else np.empty(0, np.int64)
        bounds = np.concatenate([[0], interior, [half]]).astype(np.int64)
        for _ in range(max_sweeps):
            moved = False
            for j in range(1, kh):
                lo, hi = bounds[j - 1] + 1, bounds[j + 1]
                cur = bounds[j]
                vals = [
                    interval_mi(bounds[j - 1], b) + interval_mi(b, bounds[j + 1])
                    for b in range(lo, hi)
                ]
                b_new = lo + int(np.argmax(vals))
                if b_new != cur:
                    bounds[j] = b_new
                    moved = True
            if not moved:
                break
        mi = sum(interval_mi(bounds[j], bounds[j + 1]) for j in range(kh))
        if mi > best_mi:
            best_mi, best_bounds = mi, bounds.copy()

    labels_sorted = np.empty(Y, dtype=np.int32)
    for k in range(kh):
        labels_sorted[best_bounds[k] : best_bounds[k + 1]] = k
    labels_sorted[half:] = K - 1 - labels_sorted[:half][::-1]
    labels = np.empty(Y, dtype=np.int32)
    labels[order] = labels_sorted

    p_t_given_y = np.zeros((Y, K))
    p_t_given_y[np.arange(Y), labels] = 1.0
    p_x_and_t = p_t_given_y.T @ p
    p_t = p_x_and_t.sum(axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        p_x_given_t = np.where(
            p_t[:, None] > 0, p_x_and_t / np.maximum(p_t, 1e-300)[:, None], 0.5
        )
    return QuantizerResult(
        labels=labels,
        p_t_given_y=p_t_given_y,
        p_x_given_t=p_x_given_t,
        p_t=p_t,
        mi_xt=mutual_information(p_x_and_t),
        mi_xy=mutual_information(p),
    )
