"""Discrete density evolution for irregular LDPC codes with message alignment.

Reimplements the reference's ``Discrete_Density_Evolution_class_irregular``
(Discrete_LDPC_decoding/Discrete_Density_Evolution_irreg.py): degree
distributions are tracked from the edge perspective (lambda/rho); after each
node-side DE the per-degree output densities are *aligned* (information
matching) against the density of the most informative participating degree,
and the DE feedback is the edge-weighted mixture of the aligned densities.
The per-(iteration, degree) alignment LUTs become the decoder's matching
vectors.

Reference quirks intentionally reproduced (flagged where they occur, see
SURVEY.md §7.4 and the notes below):
- the check-node reference degree is picked by max sum(|log-ratio|) over
  degrees (:97-105); ditto variable nodes with a different scale (:212-223);
- the variable-node cascade re-matches the reference degree against the
  aggregate and stores the result in matching row ``argmax - 1``
  (:266-270) — one row below the reference degree's own row. For every
  reference code that row corresponds to a degree that does not occur, so
  the quirk is harmless but kept for bit-parity (``compat_rematch_row``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..ib.tools import kl_divergence, mutual_information, numerical_guard
from .density_evolution import (
    DEDiagnostics,
    DiscreteDensityEvolution,
    checknode_joint,
    varnode_joint,
)
from .matching import information_matching
from .trellis import TrellisTables


@dataclasses.dataclass
class IrregularDEDiagnostics(DEDiagnostics):
    cost_vector: np.ndarray  # [i_max] global alignment cost (with matching)
    cost_vector_no_match: np.ndarray
    mi_matched: np.ndarray  # [i_max] I(X;T) of matched VN mixture
    mi_unmatched: np.ndarray


class DiscreteDensityEvolutionIrregular(DiscreteDensityEvolution):
    """Irregular-code discrete DE with information matching."""

    def __init__(
        self,
        p_x_and_t_channel: np.ndarray,
        cardinality_t_decoder: int,
        lambda_vec: np.ndarray,
        rho_vec: np.ndarray,
        i_max: int,
        match: bool = True,
        compat_rematch_row: bool = True,
        verbose: bool = False,
        ib_backend: str = "dp",
        ib_nror: int = 10,
        ib_seed: int = 0,
    ):
        self.lambda_vec = np.asarray(lambda_vec, dtype=np.float64)
        self.rho_vec = np.asarray(rho_vec, dtype=np.float64)
        d_v_max = self.lambda_vec.shape[0]
        d_c_max = self.rho_vec.shape[0]
        super().__init__(
            p_x_and_t_channel,
            cardinality_t_decoder,
            d_v_max,
            d_c_max,
            i_max,
            verbose,
            ib_backend=ib_backend,
            ib_nror=ib_nror,
            ib_seed=ib_seed,
        )
        self.match = match
        self.compat_rematch_row = compat_rematch_row

    def run(self) -> tuple[TrellisTables, IrregularDEDiagnostics]:
        Tch, T = self.t_channel, self.t_decoder
        d_v_max, d_c_max, i_max = self.d_v, self.d_c, self.i_max
        lam, rho = self.lambda_vec, self.rho_vec

        tables = TrellisTables(
            cardinality_t_channel=Tch,
            cardinality_t_decoder=T,
            i_max=i_max,
            d_c_max=d_c_max,
            d_v_max=d_v_max,
            cn_iter0_first=np.zeros((Tch, Tch), dtype=np.int64),
            cn_iter0_rest=np.zeros((max(d_c_max - 3, 0), T, Tch), dtype=np.int64),
            cn_rest=np.zeros((i_max - 1, d_c_max - 2, T, T), dtype=np.int64),
            vn_first=np.zeros((i_max, Tch, T), dtype=np.int64),
            vn_rest=np.zeros((i_max, d_v_max - 1, T, T), dtype=np.int64),
            matching_cn=np.zeros((i_max, d_c_max, T), dtype=np.int64),
            matching_vn=np.zeros((i_max, d_v_max, T), dtype=np.int64),
        )
        diag = IrregularDEDiagnostics(
            ext_mi_varnode_in=np.zeros(i_max + 1),
            ext_mi_checknode_in=np.zeros(i_max),
            mi_decision=np.zeros(i_max),
            mi_gain_matrix=np.zeros((i_max, d_v_max)),
            cost_vector=np.zeros(i_max),
            cost_vector_no_match=np.zeros(i_max),
            mi_matched=np.zeros(i_max),
            mi_unmatched=np.zeros(i_max),
        )

        identity = np.arange(T, dtype=np.int64)
        p_feedback = self.p_channel / self.p_channel.sum()
        diag.ext_mi_varnode_in[0] = mutual_information(p_feedback)

        for i in range(i_max):
            # ================= check-node side =================
            cn_state: list[np.ndarray] = []  # p(x, t) after partial op w
            p_first = p_feedback
            for w in range(d_c_max - 2):
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
                cn_state.append(p_first)

            # Alignment across check degrees: reference degree = max mean
            # |log-likelihood ratio| (Discrete_Density_Evolution_irreg.py:97-105).
            max_abs = np.zeros(d_c_max)
            for r_i in range(d_c_max):
                if rho[r_i] > 0:
                    s = cn_state[r_i - 2]
                    with np.errstate(divide="ignore"):
                        max_abs[r_i] = np.abs(
                            np.log(np.maximum(s[:, 0], 1e-300))
                            - np.log(np.maximum(s[:, 1], 1e-300))
                        ).sum() / 16.0
            ref_idx = int(np.argmax(max_abs))
            p_target = cn_state[ref_idx - 2]

            cn_weighted = np.zeros((T, 2))
            cn_weighted_no = np.zeros((T, 2))
            for r_i in range(d_c_max):
                if rho[r_i] <= 0:
                    continue
                cur = cn_state[r_i - 2]
                if r_i != ref_idx:
                    m = information_matching(T, cur, p_target)
                    tables.matching_cn[i, r_i, :] = m.lut
                    aligned = m.p_x_and_z
                else:
                    tables.matching_cn[i, r_i, :] = identity
                    aligned = cur
                cn_weighted += rho[r_i] * aligned
                cn_weighted_no += rho[r_i] * cur

            de_checknode_out = cn_weighted if self.match else cn_weighted_no
            diag.ext_mi_checknode_in[i] = mutual_information(de_checknode_out)

            # ================= variable-node side =================
            p_chan = self.p_channel / self.p_channel.sum()
            vn_state: list[np.ndarray] = []
            joint = varnode_joint(p_chan, de_checknode_out)
            r, p_state = self._ib(joint)
            tables.vn_first[i] = r.labels.reshape(Tch, T)
            diag.mi_gain_matrix[i, 0] = r.mi_xt
            vn_state.append(p_state)

            for w in range(1, d_v_max - 1):
                joint = varnode_joint(p_state, de_checknode_out)
                r, p_state = self._ib(joint)
                tables.vn_rest[i, w - 1] = r.labels.reshape(T, T)
                diag.mi_gain_matrix[i, w] = r.mi_xt - diag.mi_gain_matrix[i, :].sum()
                vn_state.append(p_state)

            # Alignment cascade across variable degrees
            # (Discrete_Density_Evolution_irreg.py:209-311). Degree lam_i+1
            # uses vn_state[lam_i-1]; degree-1 nodes only forward the channel
            # message and do not participate.
            max_abs = np.zeros(d_v_max)
            for lam_i in range(1, d_v_max):
                if lam[lam_i] > 0:
                    s = vn_state[lam_i - 1]
                    with np.errstate(divide="ignore"):
                        max_abs[lam_i] = np.abs(
                            np.log(np.maximum(s[:, 0], 1e-300))
                            - np.log(np.maximum(s[:, 1], 1e-300))
                        ).sum() / T
            matching_degree = int(np.argmax(max_abs)) - 1
            p_highest = vn_state[matching_degree]

            p_desired = p_highest.copy()
            nom = lam[matching_degree + 1] * p_highest
            den = lam[matching_degree + 1]
            vn_weighted = np.zeros((T, 2))
            vn_weighted_no = np.zeros((T, 2))
            p_x_given_z_per_deg: dict[int, np.ndarray] = {}
            p_z_per_deg: dict[int, np.ndarray] = {}
            for lam_i in range(1, d_v_max):
                if lam[lam_i] <= 0:
                    continue
                cur = vn_state[lam_i - 1]
                if lam_i != matching_degree + 1:
                    m = information_matching(T, cur, p_desired)
                    tables.matching_vn[i, lam_i, :] = m.lut
                    p_x_given_z_per_deg[lam_i] = m.p_x_given_z
                    p_z_per_deg[lam_i] = m.p_z
                    nom = nom + lam[lam_i] * m.p_x_and_z
                    den = den + lam[lam_i]
                    p_desired = nom / den
                    aligned = m.p_x_and_z
                else:
                    tables.matching_vn[i, lam_i, :] = identity
                    aligned = cur
                vn_weighted += lam[lam_i] * aligned
                vn_weighted_no += lam[lam_i] * cur

            # Re-match the reference degree against the aggregate
            # (:266-278); the result replaces its contribution.
            m1 = information_matching(T, p_highest, vn_weighted)
            rematch_row = matching_degree if self.compat_rematch_row else matching_degree + 1
            tables.matching_vn[i, rematch_row, :] = m1.lut
            p_x_given_z_per_deg[matching_degree + 1] = m1.p_x_given_z
            p_z_per_deg[matching_degree + 1] = m1.p_z
            vn_weighted = (
                vn_weighted
                - lam[matching_degree + 1] * p_highest
                + lam[matching_degree + 1] * m1.p_x_and_z
            )

            # Alignment-cost diagnostics (:284-310).
            p_w_cond = vn_weighted / np.maximum(
                vn_weighted.sum(1, keepdims=True), 1e-300
            )
            p_w_no_cond = vn_weighted_no / np.maximum(
                vn_weighted_no.sum(1, keepdims=True), 1e-300
            )
            cost = cost_no = 0.0
            for lam_i in range(1, d_v_max):
                if lam[lam_i] <= 0:
                    continue
                pz = p_z_per_deg[lam_i]
                pxz = p_x_given_z_per_deg[lam_i]
                cost += lam[lam_i] * float(np.dot(pz, kl_divergence(pxz, p_w_cond)))
                cost_no += lam[lam_i] * float(
                    np.dot(pz, kl_divergence(pxz, p_w_no_cond))
                )
            diag.cost_vector[i] = cost
            diag.cost_vector_no_match[i] = cost_no

            de_varnode_out = (
                vn_weighted / vn_weighted.sum()
                if self.match
                else vn_weighted_no / vn_weighted_no.sum()
            )
            diag.mi_matched[i] = mutual_information(vn_weighted)
            diag.mi_unmatched[i] = mutual_information(vn_weighted_no)

            # Decision mapping (:319-343): one extra op on the unweighted
            # chain state.
            joint = varnode_joint(p_state, de_checknode_out)
            r, _ = self._ib(joint)
            tables.vn_rest[i, d_v_max - 2] = r.labels.reshape(T, T)
            diag.mi_gain_matrix[i, -1] = r.mi_xt - diag.mi_gain_matrix[i, :].sum()
            diag.mi_decision[i] = diag.mi_matched[i] if self.match else diag.mi_unmatched[i]

            p_feedback = de_varnode_out
            diag.ext_mi_varnode_in[i + 1] = mutual_information(de_varnode_out)
            if self.verbose:
                print(
                    f"DE iteration {i}: I_cn={diag.ext_mi_checknode_in[i]:.6f} "
                    f"I_vn={diag.ext_mi_varnode_in[i + 1]:.6f} cost={cost:.3e}"
                )

        return tables, diag
