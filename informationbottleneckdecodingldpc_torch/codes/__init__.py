"""Parity-check-matrix handling: loaders, constructors, Tanner-graph layout."""

from .alist import alist_to_csr, csr_to_alist, parse_alist, format_alist
from .io import load_check_matrix, save_check_matrix
from .graph import TannerGraph
from .ensembles import (
    node_degree_distributions,
    node_to_edge_distribution,
    code_rate_from_distributions,
)
from .wlan import wlan_80211n_parity_check
from .dvbs2 import (
    DVBS2_R12_N64800_TABLE,
    dvbs2_parity_check,
    dvbs2_like_parity_check,
    dvbs2_address_table_parity_check,
    dvbs2_layout_node_keys,
    dvbs2_layout_edge_keys,
)
from .random_codes import regular_parity_check, regular_qc_parity_check

__all__ = [
    "alist_to_csr",
    "csr_to_alist",
    "parse_alist",
    "format_alist",
    "load_check_matrix",
    "save_check_matrix",
    "TannerGraph",
    "node_degree_distributions",
    "node_to_edge_distribution",
    "code_rate_from_distributions",
    "wlan_80211n_parity_check",
    "DVBS2_R12_N64800_TABLE",
    "dvbs2_parity_check",
    "dvbs2_like_parity_check",
    "dvbs2_address_table_parity_check",
    "dvbs2_layout_node_keys",
    "dvbs2_layout_edge_keys",
    "regular_parity_check",
    "regular_qc_parity_check",
]
