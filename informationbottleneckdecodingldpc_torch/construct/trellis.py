"""Trellis lookup-table container and reference-flat-layout conversion.

The reference flattens all per-(iteration, step) LUTs into two 1-D integer
vectors with offset arithmetic spread across construction and kernels
(SURVEY.md §3.1, Discrete_Density_Evolution.py:92-122,299-344). The dense
layout here keeps each table addressable as ``[iteration, step, in1, in2]``;
:func:`TrellisTables.to_flat` / :func:`TrellisTables.from_flat` convert to and
from the reference's exact flat layout (used by config I/O parity tests).

Flat layout reproduced (lengths in ints):
- check nodes: ``Tch^2`` (iter 0, step 0; index ``t0*Tch + t1``), then
  ``(d_c-3)`` blocks of ``T*Tch`` (iter 0, steps l>=1; index ``t_prev*Tch + y``
  as filled by DE — note the reference kernel reads these blocks with stride
  ``T`` (kernels_template.cl:83-85), identical only when ``Tch == T``, which
  holds for every reference config), then ``(i_max-1)*(d_c-2)`` blocks of
  ``T^2`` (index ``t_prev*T + t``).
- variable nodes: per iteration ``Tch*T`` (first step, index ``ch*T + t``)
  followed by ``(d_v-1)`` blocks of ``T^2``.
- matching vectors: row-major reshape of ``[i_max, d_max, T]``
  (Discrete_Density_Evolution_irreg.py:430-432).
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

    # -- reference flat layout ---------------------------------------------
    def to_flat(self) -> tuple[np.ndarray, np.ndarray]:
        Tch, T = self.cardinality_t_channel, self.cardinality_t_decoder
        cn = np.concatenate(
            [
                self.cn_iter0_first.reshape(-1),
                self.cn_iter0_rest.reshape(-1),
                self.cn_rest.reshape(-1),
            ]
        ).astype(np.int64)
        vn_parts = []
        for i in range(self.i_max):
            vn_parts.append(self.vn_first[i].reshape(-1))
            vn_parts.append(self.vn_rest[i].reshape(-1))
        vn = np.concatenate(vn_parts).astype(np.int64)
        expected_cn = (
            Tch**2 + (self.d_c_max - 3) * T * Tch + (self.i_max - 1) * (self.d_c_max - 2) * T**2
        )
        expected_vn = self.i_max * (Tch * T + (self.d_v_max - 1) * T**2)
        assert cn.size == expected_cn and vn.size == expected_vn
        return cn, vn

    def flat_matching(self) -> tuple[np.ndarray, np.ndarray]:
        assert self.has_matching
        return (
            self.matching_cn.reshape(-1).astype(np.int64),
            self.matching_vn.reshape(-1).astype(np.int64),
        )

    @classmethod
    def from_flat(
        cls,
        cn_vec: np.ndarray,
        vn_vec: np.ndarray,
        cardinality_t_channel: int,
        cardinality_t_decoder: int,
        i_max: int,
        d_c_max: int,
        d_v_max: int,
        matching_cn_vec: np.ndarray | None = None,
        matching_vn_vec: np.ndarray | None = None,
    ) -> "TrellisTables":
        Tch, T = cardinality_t_channel, cardinality_t_decoder
        cn_vec = np.asarray(cn_vec, dtype=np.int64)
        vn_vec = np.asarray(vn_vec, dtype=np.int64)
        o = Tch * Tch
        cn_iter0_first = cn_vec[:o].reshape(Tch, Tch)
        n_rest0 = max(d_c_max - 3, 0)
        cn_iter0_rest = cn_vec[o : o + n_rest0 * T * Tch].reshape(n_rest0, T, Tch)
        o += n_rest0 * T * Tch
        cn_rest = cn_vec[o:].reshape(i_max - 1, d_c_max - 2, T, T)

        per_iter = Tch * T + (d_v_max - 1) * T * T
        vn_first = np.empty((i_max, Tch, T), dtype=np.int64)
        vn_rest = np.empty((i_max, d_v_max - 1, T, T), dtype=np.int64)
        for i in range(i_max):
            block = vn_vec[i * per_iter : (i + 1) * per_iter]
            vn_first[i] = block[: Tch * T].reshape(Tch, T)
            vn_rest[i] = block[Tch * T :].reshape(d_v_max - 1, T, T)

        matching_cn = (
            np.asarray(matching_cn_vec, dtype=np.int64).reshape(i_max, d_c_max, T)
            if matching_cn_vec is not None
            else None
        )
        matching_vn = (
            np.asarray(matching_vn_vec, dtype=np.int64).reshape(i_max, d_v_max, T)
            if matching_vn_vec is not None
            else None
        )
        return cls(
            cardinality_t_channel=Tch,
            cardinality_t_decoder=T,
            i_max=i_max,
            d_c_max=d_c_max,
            d_v_max=d_v_max,
            cn_iter0_first=cn_iter0_first,
            cn_iter0_rest=cn_iter0_rest,
            cn_rest=cn_rest,
            vn_first=vn_first,
            vn_rest=vn_rest,
            matching_cn=matching_cn,
            matching_vn=matching_vn,
        )
