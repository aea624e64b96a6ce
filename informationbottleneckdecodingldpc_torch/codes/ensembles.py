"""Degree distributions and code-rate utilities.

Conventions follow the reference (Information_Matching.py:15-31,
discrete_LDPC_decoder_irreg.py:69-100): a node-perspective distribution
``dist[d-1]`` is the fraction of nodes with degree ``d``; the edge-perspective
distribution ("lambda"/"rho") is ``dist * d / sum(dist * d)``.
"""

from __future__ import annotations

import numpy as np


def node_degree_distributions(
    vn_degree: np.ndarray, cn_degree: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Node-perspective (d_v_dist, d_c_dist) from per-node degrees."""

    def dist(degrees: np.ndarray) -> np.ndarray:
        d_max = int(degrees.max())
        out = np.bincount(degrees.astype(np.int64), minlength=d_max + 1)[1:]
        return out / out.sum()

    return dist(vn_degree), dist(cn_degree)


def node_to_edge_distribution(node_dist: np.ndarray) -> np.ndarray:
    """Edge-perspective distribution from a node-perspective one
    (Information_Matching.py:15-20)."""
    values = np.arange(node_dist.shape[0]) + 1
    weighted = node_dist * values
    return weighted / weighted.sum()


def code_rate_from_distributions(
    d_v_dist: np.ndarray, d_c_dist: np.ndarray
) -> float:
    """R_c = 1 - E[d_v]/E[d_c] over node-perspective distributions."""
    nom = float(np.dot(d_v_dist, np.arange(d_v_dist.shape[0]) + 1))
    den = float(np.dot(d_c_dist, np.arange(d_c_dist.shape[0]) + 1))
    return 1.0 - nom / den
