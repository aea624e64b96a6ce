"""Loading of constructed decoder configs (port of ``DecoderConfig.load``).

Reads the same version-tagged ``.npz`` files that the JAX package's
``construct/awgn_dde.py`` writes. Construction (density evolution) stays in
the JAX package on the host; the port only loads its result.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .trellis import TrellisTables


@dataclasses.dataclass
class DecoderConfig:
    """Constructed discrete-decoder artifact."""

    tables: TrellisTables
    design_ebn0_db: float
    sigma2: float
    ad_max_abs: float
    cardinality_y_channel: int
    code_rate: float
    lambda_vec: np.ndarray | None
    rho_vec: np.ndarray | None
    mi_trajectory: np.ndarray
    diagnostics: dict = dataclasses.field(default_factory=dict)

    @property
    def is_irregular(self) -> bool:
        return self.tables.has_matching

    @classmethod
    def load(cls, path: str) -> "DecoderConfig":
        with np.load(path) as z:
            tables = TrellisTables(
                cardinality_t_channel=int(z["cardinality_t_channel"]),
                cardinality_t_decoder=int(z["cardinality_t_decoder"]),
                i_max=int(z["i_max"]),
                d_c_max=int(z["d_c_max"]),
                d_v_max=int(z["d_v_max"]),
                cn_iter0_first=z["cn_iter0_first"],
                cn_iter0_rest=z["cn_iter0_rest"],
                cn_rest=z["cn_rest"],
                vn_first=z["vn_first"],
                vn_rest=z["vn_rest"],
                matching_cn=z["matching_cn"] if "matching_cn" in z else None,
                matching_vn=z["matching_vn"] if "matching_vn" in z else None,
            )
            return cls(
                tables=tables,
                design_ebn0_db=float(z["design_ebn0_db"]),
                sigma2=float(z["sigma2"]),
                ad_max_abs=float(z["ad_max_abs"]),
                cardinality_y_channel=int(z["cardinality_y_channel"]),
                code_rate=float(z["code_rate"]),
                lambda_vec=z["lambda_vec"] if "lambda_vec" in z else None,
                rho_vec=z["rho_vec"] if "rho_vec" in z else None,
                mi_trajectory=z["mi_trajectory"],
                diagnostics={
                    k[len("diag_"):]: z[k]
                    for k in z.files
                    if k.startswith("diag_")
                },
            )
