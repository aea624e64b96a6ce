"""Channel: AWGN noise scale and the channel-output quantizer."""

from .awgn import sigma2_from_ebn0_db
from .quantizer import (
    DeviceQuantizerTables,
    QuantizerTables,
    build_quantizer_tables,
    device_tables,
    quantize_with,
    sample_clusters_from_uniform,
)

__all__ = [
    "DeviceQuantizerTables",
    "QuantizerTables",
    "build_quantizer_tables",
    "device_tables",
    "quantize_with",
    "sample_clusters_from_uniform",
    "sigma2_from_ebn0_db",
]
