"""Information matching (message alignment) for irregular codes.

Equivalent of the reference's ``information_matching_v2``
(Discrete_LDPC_decoding/Information_Matching.py:34-77): find the
deterministic remap z = f(t) minimizing D_KL(p(x|t) || p(x|Z1=z)) per cluster
against a reference distribution, and return the remapped statistics.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..ib.tools import kl_divergence


@dataclasses.dataclass(frozen=True)
class MatchingResult:
    p_x_given_z: np.ndarray  # [K, 2]
    p_x_and_z: np.ndarray  # [K, 2]
    p_z: np.ndarray  # [K]
    lut: np.ndarray  # [K] int: z = lut[t]


def information_matching(
    cardinality: int, p_x_and_t0: np.ndarray, p_x_and_z1: np.ndarray
) -> MatchingResult:
    K = int(cardinality)
    p_x_and_t0 = np.asarray(p_x_and_t0, dtype=np.float64)
    p_x_and_z1 = np.asarray(p_x_and_z1, dtype=np.float64)
    p_t0 = p_x_and_t0.sum(axis=1)
    p_x_given_t0 = p_x_and_t0 / np.maximum(p_t0, 1e-300)[:, None]
    p_x_given_z1 = p_x_and_z1 / np.maximum(p_x_and_z1.sum(axis=1), 1e-300)[:, None]

    lut = np.empty(K, dtype=np.int64)
    for t0 in range(K):
        lut[t0] = int(np.argmin(kl_divergence(p_x_given_t0[t0], p_x_given_z1)))

    p_z = np.zeros(K)
    p_x_and_z = np.zeros((K, 2))
    for t0, z in enumerate(lut):
        p_z[z] += p_t0[t0]
        p_x_and_z[z] += p_x_and_t0[t0]
    # Reference adds 1e-80 to guard empty clusters (Information_Matching.py:74).
    p_x_given_z = p_x_and_z / (p_z[:, None] + 1e-80)
    return MatchingResult(
        p_x_given_z=p_x_given_z, p_x_and_z=p_x_and_z, p_z=p_z, lut=lut
    )
