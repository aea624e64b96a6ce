"""Model zoo: the reference's three code families plus small test variants.

The port's copy of the JAX package's ``models/zoo.py``: the same models and
settings, built on the port's ``codes``; ``make_layout`` returns the port's
:class:`DecodeLayout`.

Mirrors the reference scenario directories (SURVEY.md §2.1 #16-18):
- ``regular-3-6-8000``: MacKay-style regular (3,6) N=8000 (ensemble-matched
  seeded construction; the reference's 8000.4000.3.483 file ships with
  neither repo), |T_ch|=|T|=16, DE i_max=250, design 1.05-1.25 dB
  (Regular_LDPC_Decoding/BPSK/decoder_config_generation.py:16-39).
- ``wlan-1296``: IEEE 802.11n R=1/2 N=1296, |T|=16 or 32, i_max=50,
  design 0.6-0.9 dB (Irregular_LDPC_Decoding/WLAN/decoder_config_generation.py:24-37).
- ``dvbs2-64800``: DVB-S2 R=1/2 N=64800 profile, |T|=16, i_max=50,
  design 0.6 dB (Irregular_LDPC_Decoding/DVB-S2/decoder_config_generation.py:20-34).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import scipy.sparse as sp

from ..codes import (
    TannerGraph,
    dvbs2_layout_edge_keys,
    dvbs2_layout_node_keys,
    dvbs2_parity_check,
    regular_qc_parity_check,
    wlan_80211n_parity_check,
)
from ..decode.graph_arrays import DecodeLayout


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    name: str
    make_h: Callable[[], sp.csr_matrix]
    irregular: bool
    # Decoder construction defaults.
    cardinality_t_channel: int
    cardinality_t_decoder: int
    de_i_max: int
    design_ebn0_db: float
    # Simulation defaults (reference operating points, BASELINE.md).
    decode_i_max: int
    sweep_max_db: float
    min_errors: int
    batch_hint: int
    count_all_bits: bool  # all-zeros regular path counts every bit
    # Regular-code degrees (None for irregular).
    d_v: int | None = None
    d_c: int | None = None
    # Optional decode-layout node-order keys (structured routing).
    layout_keys: Callable[[], tuple] | None = None
    # Optional per-edge inbox-slot sort keys (H -> (csr_key, csc_key)).
    layout_edge_keys: Callable[[sp.csr_matrix], tuple] | None = None

    def make_layout(self, H: sp.csr_matrix | None = None) -> DecodeLayout:
        """TannerGraph + the port's DecodeLayout with this model's structured
        ordering."""
        if H is None:
            H = self.make_h()
        g = TannerGraph.from_check_matrix(H)
        keys = self.layout_keys() if self.layout_keys else (None, None)
        ekeys = self.layout_edge_keys(H) if self.layout_edge_keys else (None, None)
        return DecodeLayout.from_graph(
            g,
            cn_node_key=keys[0],
            vn_node_key=keys[1],
            cn_edge_key=ekeys[0],
            vn_edge_key=ekeys[1],
        )


MODELS: dict[str, ModelSpec] = {
    "regular-3-6-8000": ModelSpec(
        name="regular-3-6-8000",
        make_h=lambda: regular_qc_parity_check(8000, 3, 6, seed=483),
        irregular=False,
        cardinality_t_channel=16,
        cardinality_t_decoder=16,
        de_i_max=250,
        design_ebn0_db=1.25,
        decode_i_max=250,
        sweep_max_db=2.0,
        min_errors=7000,
        batch_hint=128,
        count_all_bits=True,
        d_v=3,
        d_c=6,
    ),
    "regular-3-6-504": ModelSpec(  # fast test variant
        name="regular-3-6-504",
        make_h=lambda: regular_qc_parity_check(504, 3, 6, seed=7),
        irregular=False,
        cardinality_t_channel=16,
        cardinality_t_decoder=16,
        de_i_max=30,
        design_ebn0_db=1.5,
        decode_i_max=30,
        sweep_max_db=3.0,
        min_errors=2000,
        batch_hint=64,
        count_all_bits=True,
        d_v=3,
        d_c=6,
    ),
    "wlan-1296": ModelSpec(
        name="wlan-1296",
        make_h=wlan_80211n_parity_check,
        irregular=True,
        cardinality_t_channel=16,
        cardinality_t_decoder=16,
        de_i_max=50,
        design_ebn0_db=0.8,
        decode_i_max=50,
        sweep_max_db=2.5,
        min_errors=7000,
        batch_hint=256,
        count_all_bits=False,
    ),
    "wlan-1296-T32": ModelSpec(
        name="wlan-1296-T32",
        make_h=wlan_80211n_parity_check,
        irregular=True,
        cardinality_t_channel=32,
        cardinality_t_decoder=32,
        de_i_max=50,
        design_ebn0_db=0.6,
        decode_i_max=50,
        sweep_max_db=2.5,
        min_errors=7000,
        batch_hint=256,
        count_all_bits=False,
    ),
    "dvbs2-64800": ModelSpec(
        name="dvbs2-64800",
        make_h=lambda: dvbs2_parity_check("1/2", 64800),
        layout_keys=lambda: dvbs2_layout_node_keys(64800, 32400),
        layout_edge_keys=lambda H: dvbs2_layout_edge_keys(H, 32400),
        irregular=True,
        cardinality_t_channel=16,
        cardinality_t_decoder=16,
        de_i_max=50,
        design_ebn0_db=0.6,
        decode_i_max=50,
        sweep_max_db=1.2,
        min_errors=5000,
        batch_hint=32,
        count_all_bits=False,
    ),
}


def get_model(name: str) -> ModelSpec:
    if name not in MODELS:
        raise KeyError(f"unknown model {name!r}; available: {sorted(MODELS)}")
    return MODELS[name]
