"""Decoder-config factory: AWGN quantizer + discrete density evolution.

Equivalent of the reference's ``AWGN_Discrete_Density_Evolution_class[_irregular]``
(AWGN_Channel_Transmission/AWGN_Discrete_Density_Evolution.py:26-259): bind the
channel quantizer's p(x, t) to density evolution for a design Eb/N0 and persist
the constructed decoder. Persistence is a plain ``.npz`` of arrays (version
tagged) instead of the reference's pickle of an instance ``__dict__``
(:197-206) — reproducible across versions and loadable on any host.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..channel.awgn import ebn0_db_from_sigma2, sigma2_from_ebn0_db
from ..channel.quantizer import build_quantizer_tables
from ..codes.ensembles import (
    code_rate_from_distributions,
    node_degree_distributions,
    node_to_edge_distribution,
)
from .density_evolution import DiscreteDensityEvolution
from .density_evolution_irreg import DiscreteDensityEvolutionIrregular
from .trellis import TrellisTables

CONFIG_VERSION = 1


@dataclasses.dataclass
class DecoderConfig:
    """Constructed discrete-decoder artifact."""

    tables: TrellisTables
    design_ebn0_db: float
    sigma2: float
    ad_max_abs: float
    cardinality_y_channel: int
    code_rate: float
    lambda_vec: np.ndarray | None  # edge-perspective VN degree distribution
    rho_vec: np.ndarray | None
    mi_trajectory: np.ndarray  # decision-mapping I(X;T) per iteration
    # Full DE diagnostics (ext_mi_* trajectories, MI gain matrix, matching
    # costs for irregular codes) — the reference persists/plots these
    # (Discrete_Density_Evolution.py:273-286, decoder_config_generation.py:45-61).
    diagnostics: dict = dataclasses.field(default_factory=dict)

    @property
    def is_irregular(self) -> bool:
        return self.tables.has_matching

    def save(self, path: str) -> None:
        t = self.tables
        arrays = dict(
            version=np.asarray(CONFIG_VERSION),
            cardinality_t_channel=np.asarray(t.cardinality_t_channel),
            cardinality_t_decoder=np.asarray(t.cardinality_t_decoder),
            i_max=np.asarray(t.i_max),
            d_c_max=np.asarray(t.d_c_max),
            d_v_max=np.asarray(t.d_v_max),
            cn_iter0_first=t.cn_iter0_first,
            cn_iter0_rest=t.cn_iter0_rest,
            cn_rest=t.cn_rest,
            vn_first=t.vn_first,
            vn_rest=t.vn_rest,
            design_ebn0_db=np.asarray(self.design_ebn0_db),
            sigma2=np.asarray(self.sigma2),
            ad_max_abs=np.asarray(self.ad_max_abs),
            cardinality_y_channel=np.asarray(self.cardinality_y_channel),
            code_rate=np.asarray(self.code_rate),
            mi_trajectory=self.mi_trajectory,
        )
        if t.matching_cn is not None:
            arrays["matching_cn"] = t.matching_cn
            arrays["matching_vn"] = t.matching_vn
        if self.lambda_vec is not None:
            arrays["lambda_vec"] = self.lambda_vec
            arrays["rho_vec"] = self.rho_vec
        for k, v in self.diagnostics.items():
            arrays[f"diag_{k}"] = np.asarray(v)
        np.savez_compressed(path, **arrays)

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

    def export_exit_chart(self, path: str, label: str = "") -> None:
        """EXIT-style MI trajectory chart (the reference's construction plot,
        Regular_LDPC_Decoding/BPSK/decoder_config_generation.py:42-61):
        staircase of (I at check-node input, I at variable-node input).
        Skipped, with a note, when matplotlib is missing."""
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            print(f"no matplotlib: the exit chart {path} is not written", flush=True)
            return

        mi_cn = np.asarray(self.diagnostics["ext_mi_checknode_in"])
        mi_vn = np.asarray(self.diagnostics["ext_mi_varnode_in"])
        i_max = mi_cn.shape[0]
        x = np.zeros(2 * i_max - 1)
        y = np.zeros(2 * i_max - 1)
        y[0] = mi_vn[0]
        for i in range(1, i_max):
            x[2 * i - 1] = mi_cn[i - 1]
            y[2 * i - 1] = y[2 * i - 2]
            x[2 * i] = x[2 * i - 1]
            y[2 * i] = mi_vn[i]
        fig, ax = plt.subplots(figsize=(5, 4))
        ax.plot(x, y, drawstyle="default",
                label=label or f"{self.design_ebn0_db} dB")
        ax.plot(self.mi_trajectory, linestyle="--", alpha=0.6,
                label="decision I(X;T)")
        ax.set_xlabel("I at check-node input")
        ax.set_ylabel("I at variable-node input")
        ax.set_title("Discrete DE MI trajectory")
        ax.legend()
        ax.grid(alpha=0.3)
        fig.tight_layout()
        fig.savefig(path, dpi=150)
        plt.close(fig)


def build_decoder_config(
    design_ebn0_db: float | None = None,
    sigma2: float | None = None,
    ad_max_abs: float = 3.0,
    cardinality_y_channel: int = 2000,
    cardinality_t_channel: int = 16,
    cardinality_t_decoder: int = 16,
    i_max: int = 50,
    d_v: int | None = None,
    d_c: int | None = None,
    H=None,
    match: bool = True,
    verbose: bool = False,
    ib_backend: str = "dp",
    ib_nror: int = 10,
    ib_seed: int = 0,
) -> DecoderConfig:
    """Construct a discrete decoder for a design Eb/N0 (or noise variance).

    Regular codes: pass ``d_v``/``d_c``. Irregular codes: pass the parity
    check matrix ``H`` — lambda/rho are derived from it like the reference's
    irregular DDE (AWGN_Discrete_Density_Evolution.py:232-241).
    """
    if H is not None:
        from ..codes.graph import TannerGraph

        g = TannerGraph.from_check_matrix(H)
        d_v_dist, d_c_dist = node_degree_distributions(g.vn_degree, g.cn_degree)
        lambda_vec = node_to_edge_distribution(d_v_dist)
        rho_vec = node_to_edge_distribution(d_c_dist)
        code_rate = code_rate_from_distributions(d_v_dist, d_c_dist)
    elif d_v is not None and d_c is not None:
        lambda_vec = rho_vec = None
        code_rate = 1.0 - d_v / d_c
    else:
        raise ValueError("pass either H or (d_v, d_c)")

    if sigma2 is None:
        if design_ebn0_db is None:
            raise ValueError("pass design_ebn0_db or sigma2")
        sigma2 = float(sigma2_from_ebn0_db(design_ebn0_db, code_rate))
    else:
        design_ebn0_db = float(ebn0_db_from_sigma2(sigma2, code_rate))

    qt = build_quantizer_tables(
        sigma2, ad_max_abs, cardinality_t_channel, cardinality_y_channel
    )

    ib_kw = dict(ib_backend=ib_backend, ib_nror=ib_nror, ib_seed=ib_seed)
    if lambda_vec is None:
        de = DiscreteDensityEvolution(
            qt.p_x_and_t, cardinality_t_decoder, d_v, d_c, i_max,
            verbose=verbose, **ib_kw,
        )
    else:
        de = DiscreteDensityEvolutionIrregular(
            qt.p_x_and_t,
            cardinality_t_decoder,
            lambda_vec,
            rho_vec,
            i_max,
            match=match,
            verbose=verbose,
            **ib_kw,
        )
    tables, diag = de.run()
    return DecoderConfig(
        tables=tables,
        design_ebn0_db=float(design_ebn0_db),
        sigma2=float(sigma2),
        ad_max_abs=float(ad_max_abs),
        cardinality_y_channel=int(cardinality_y_channel),
        code_rate=float(code_rate),
        lambda_vec=lambda_vec,
        rho_vec=rho_vec,
        mi_trajectory=diag.mi_decision,
        diagnostics={
            k: np.asarray(v) for k, v in dataclasses.asdict(diag).items()
        },
    )
