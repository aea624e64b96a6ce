"""Information-theory utilities (base-2 logs, joint pmfs as [Y, X] arrays).

Equivalent surface to ``information_bottleneck.tools.inf_theory_tools`` used
by the reference (Discrete_Density_Evolution.py:4, Information_Matching.py:2):
``mutual_information(p_joint)`` and ``kl_divergence(p, q)``.
"""

from __future__ import annotations

import numpy as np

_EPS = 1e-300


def mutual_information(p_joint: np.ndarray) -> float:
    """I(X;Y) in bits from a joint pmf with rows=y, cols=x.

    Tolerates unnormalized inputs by normalizing first (the reference
    normalizes its DE joints before calling, Discrete_Density_Evolution.py:267).
    """
    p = np.asarray(p_joint, dtype=np.float64)
    p = p / p.sum()
    py = p.sum(axis=1, keepdims=True)
    px = p.sum(axis=0, keepdims=True)
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.where(p > 0, p / np.maximum(py * px, _EPS), 1.0)
        terms = np.where(p > 0, p * np.log2(ratio), 0.0)
    return float(terms.sum())


def kl_divergence(p: np.ndarray, q: np.ndarray) -> np.ndarray:
    """D_KL(p || q) in bits, broadcasting over leading axes of q.

    Matches the reference usage pattern
    ``kl_divergence(p_x_given_t0[t0, :], p_x_given_z1)`` where q is a [Z, X]
    matrix and the result is a length-Z vector
    (Information_Matching.py:62-63).
    """
    p = np.asarray(p, dtype=np.float64)
    q = np.asarray(q, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        logr = np.where(p > 0, np.log2(np.maximum(p, _EPS) / np.maximum(q, _EPS)), 0.0)
    return (p * logr).sum(axis=-1)


def numerical_guard(
    pdf: np.ndarray, p_min: float = 1e-15, p_max: float = 0.5 - 1e-15
) -> np.ndarray:
    """Clip a joint pmf away from 0/0.5 and renormalize.

    Same guard as the reference DE (Discrete_Density_Evolution.py:434-440,
    PROBABILITY_MIN/MAX_JOINT_PDF :35-36).
    """
    out = np.clip(np.asarray(pdf, dtype=np.float64), p_min, p_max)
    return out / out.sum()
