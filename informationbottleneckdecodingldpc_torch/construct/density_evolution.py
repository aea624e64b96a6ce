"""Discrete density evolution for regular LDPC codes.

Reimplements the reference's ``Discrete_Density_Evolution_class``
(Discrete_LDPC_decoding/Discrete_Density_Evolution.py) with the exact DP
symmetric IB as the compression step. The tracked joint pmf p(x, t) is
evolved through ``i_max`` decoding iterations; every partial node operation
spawns one IB problem whose deterministic clustering becomes a trellis LUT
slice (assembled directly into the dense :class:`TrellisTables` layout rather
than the reference's flat offset vectors, SURVEY.md §3.1).

Joint-construction rules (row index is ``card2 * t_first + y_second``):
- check node (XOR of inputs, Discrete_Density_Evolution.py:346-388):
  p(x=0) pairs equal bits, p(x=1) pairs differing bits;
- variable node (equality constraint, :390-432): p(x) = 2 p1(x) p2(x).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..ib.dp_quantizer import optimal_symmetric_quantizer
from ..ib.tools import mutual_information, numerical_guard
from .trellis import TrellisTables


def checknode_joint(p_first: np.ndarray, p_second: np.ndarray) -> np.ndarray:
    """p(x, [t, y]) for the XOR of two binary-symmetric inputs."""
    out0 = np.outer(p_first[:, 0], p_second[:, 0]) + np.outer(p_first[:, 1], p_second[:, 1])
    out1 = np.outer(p_first[:, 0], p_second[:, 1]) + np.outer(p_first[:, 1], p_second[:, 0])
    return np.stack([out0.ravel(), out1.ravel()], axis=1)


def varnode_joint(p_first: np.ndarray, p_second: np.ndarray) -> np.ndarray:
    """p(x, [t, y]) for two observations of the same bit (prior 1/2)."""
    out0 = 2.0 * np.outer(p_first[:, 0], p_second[:, 0])
    out1 = 2.0 * np.outer(p_first[:, 1], p_second[:, 1])
    return np.stack([out0.ravel(), out1.ravel()], axis=1)


@dataclasses.dataclass
class DEDiagnostics:
    """Mutual-information trajectories (the reference's ext_mi_* /
    MI_T_dvm1_v_X_dvm1_v vectors, Discrete_Density_Evolution.py:127-129,
    :273-286)."""

    ext_mi_varnode_in: np.ndarray  # [i_max + 1]
    ext_mi_checknode_in: np.ndarray  # [i_max]
    mi_decision: np.ndarray  # [i_max] I(X; T) of the decision mapping
    mi_gain_matrix: np.ndarray  # [i_max, d_v]


class DiscreteDensityEvolution:
    """Regular-code discrete DE producing trellis LUTs."""

    def __init__(
        self,
        p_x_and_t_channel: np.ndarray,
        cardinality_t_decoder: int,
        d_v: int,
        d_c: int,
        i_max: int,
        verbose: bool = False,
        ib_backend: str = "dp",  # 'dp' (exact) | 'sib' (randomized restarts)
        ib_nror: int = 10,
        ib_seed: int = 0,
    ):
        self.p_channel = np.asarray(p_x_and_t_channel, dtype=np.float64)
        self.t_channel = self.p_channel.shape[0]
        self.t_decoder = int(cardinality_t_decoder)
        self.d_v = int(d_v)
        self.d_c = int(d_c)
        self.i_max = int(i_max)
        self.verbose = verbose
        if ib_backend not in ("dp", "sib"):
            raise ValueError(f"unknown ib_backend {ib_backend!r}")
        # 'sib' reproduces the reference's construction stack: randomized
        # sequential symmetric IB with ``nror`` restarts per compression step
        # (lin_sym_sIB, Discrete_Density_Evolution.py:138-145). Its per-step
        # I(X;T) is <= the exact DP's by construction, but near-threshold
        # designs may follow a different DE *trajectory* — this backend
        # exists to test exactly that (round-2 verdict #2).
        self.ib_backend = ib_backend
        self.ib_nror = int(ib_nror)
        self.ib_seed = int(ib_seed)
        self._ib_calls = 0

    def _ib(self, joint: np.ndarray):
        joint = numerical_guard(joint)
        if self.ib_backend == "sib":
            from ..ib.sib import sequential_sib

            self._ib_calls += 1
            r = sequential_sib(
                joint,
                self.t_decoder,
                nror=self.ib_nror,
                seed=self.ib_seed + self._ib_calls,
            )
        else:
            r = optimal_symmetric_quantizer(joint, self.t_decoder)
        p_x_and_t = r.p_x_given_t * r.p_t[:, None]
        if self.verbose:
            print(f"I(X;T)={r.mi_xt:.6f}  I(X;Y)={r.mi_xy:.6f}")
        return r, p_x_and_t

    def run(self) -> tuple[TrellisTables, DEDiagnostics]:
        Tch, T = self.t_channel, self.t_decoder
        d_v, d_c, i_max = self.d_v, self.d_c, self.i_max

        tables = TrellisTables(
            cardinality_t_channel=Tch,
            cardinality_t_decoder=T,
            i_max=i_max,
            d_c_max=d_c,
            d_v_max=d_v,
            cn_iter0_first=np.zeros((Tch, Tch), dtype=np.int64),
            cn_iter0_rest=np.zeros((max(d_c - 3, 0), T, Tch), dtype=np.int64),
            cn_rest=np.zeros((i_max - 1, d_c - 2, T, T), dtype=np.int64),
            vn_first=np.zeros((i_max, Tch, T), dtype=np.int64),
            vn_rest=np.zeros((i_max, d_v - 1, T, T), dtype=np.int64),
        )
        diag = DEDiagnostics(
            ext_mi_varnode_in=np.zeros(i_max + 1),
            ext_mi_checknode_in=np.zeros(i_max),
            mi_decision=np.zeros(i_max),
            mi_gain_matrix=np.zeros((i_max, d_v)),
        )

        p_feedback = self.p_channel / self.p_channel.sum()
        diag.ext_mi_varnode_in[0] = mutual_information(p_feedback)

        for i in range(i_max):
            # ---- check-node DE: d_c - 2 partial ops ----
            p_first = p_feedback
            for w in range(d_c - 2):
                joint = checknode_joint(p_first, p_feedback)
                r, p_first = self._ib(joint)
                card2 = p_feedback.shape[0]
                labels = r.labels.reshape(-1, card2)
                if i == 0 and w == 0:
                    tables.cn_iter0_first[:, :] = labels
                elif i == 0:
                    tables.cn_iter0_rest[w - 1] = labels
                else:
                    tables.cn_rest[i - 1, w] = labels
            de_checknode_out = p_first
            diag.ext_mi_checknode_in[i] = mutual_information(de_checknode_out)

            # ---- variable-node DE: first op (channel x message), then
            # d_v - 2 partial ops, then the decision mapping ----
            p_chan = self.p_channel / self.p_channel.sum()
            joint = varnode_joint(p_chan, de_checknode_out)
            r, p_state = self._ib(joint)
            tables.vn_first[i] = r.labels.reshape(Tch, T)
            diag.mi_gain_matrix[i, 0] = r.mi_xt

            for w in range(1, d_v - 1):
                joint = varnode_joint(p_state, de_checknode_out)
                r, p_state = self._ib(joint)
                tables.vn_rest[i, w - 1] = r.labels.reshape(T, T)
                diag.mi_gain_matrix[i, w] = r.mi_xt - diag.mi_gain_matrix[i, :].sum()

            de_varnode_out = p_state / p_state.sum()

            # Decision mapping: one extra op folding the last message.
            joint = varnode_joint(p_state, de_checknode_out)
            r, _ = self._ib(joint)
            tables.vn_rest[i, d_v - 2] = r.labels.reshape(T, T)
            diag.mi_gain_matrix[i, -1] = r.mi_xt - diag.mi_gain_matrix[i, :].sum()
            diag.mi_decision[i] = r.mi_xt

            p_feedback = de_varnode_out
            diag.ext_mi_varnode_in[i + 1] = mutual_information(de_varnode_out)
            if self.verbose:
                print(
                    f"DE iteration {i}: I(X;T_cn)={diag.ext_mi_checknode_in[i]:.6f} "
                    f"I(X;T_vn)={diag.ext_mi_varnode_in[i + 1]:.6f}"
                )

        return tables, diag
