"""Trellis lookup-table container (port of ``construct/trellis.py``).

Each pairwise table is addressable as ``[iteration, step, state, message]``
and maps to a cluster in ``[0, T)``. The reference's flat layout conversions
(``to_flat`` / ``from_flat``) are not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TrellisTables:
    cardinality_t_channel: int
    cardinality_t_decoder: int
    i_max: int
    d_c_max: int
    d_v_max: int
    # Check-node tables.
    cn_iter0_first: np.ndarray  # [Tch, Tch] -> T
    cn_iter0_rest: np.ndarray  # [d_c_max-3, T, Tch] -> T
    cn_rest: np.ndarray  # [i_max-1, d_c_max-2, T, T] -> T
    # Variable-node tables.
    vn_first: np.ndarray  # [i_max, Tch, T] -> T
    vn_rest: np.ndarray  # [i_max, d_v_max-1, T, T] -> T
    # Message-alignment tables (irregular codes only).
    matching_cn: np.ndarray | None = None  # [i_max, d_c_max, T] -> T
    matching_vn: np.ndarray | None = None  # [i_max, d_v_max, T] -> T

    @property
    def has_matching(self) -> bool:
        return self.matching_cn is not None and self.matching_vn is not None
