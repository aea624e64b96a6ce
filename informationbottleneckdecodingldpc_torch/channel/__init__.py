"""Channel: AWGN noise scale, BPSK mapping and the channel-output quantizer."""

from .awgn import sigma2_from_ebn0_db
from .modulation import bpsk_map
from .quantizer import (
    DeviceQuantizerTables,
    QuantizerTables,
    build_quantizer_tables,
    device_tables,
    quantize_llr_with,
    quantize_with,
    sample_clusters_from_uniform,
    sample_llrs_from_uniform,
)

__all__ = [
    "DeviceQuantizerTables",
    "QuantizerTables",
    "bpsk_map",
    "build_quantizer_tables",
    "device_tables",
    "quantize_llr_with",
    "quantize_with",
    "sample_clusters_from_uniform",
    "sample_llrs_from_uniform",
    "sigma2_from_ebn0_db",
]
