"""Channel: modulation (BPSK, QAM, M-PSK) and transmitters, the AWGN channel
and its Eb/N0 conventions, the exact soft demappers, and the channel-output
quantizer."""

from .awgn import awgn_transmit, ebn0_db_from_sigma2, sigma2_from_ebn0_db
from .demap import demap_llrs, mpsk_bit_llrs, n0_from_sigma2, qam_bit_llrs
from .modulation import (
    Constellation,
    LDPCTransmitter,
    Transmitter,
    bpsk_map,
    gray_encoding_table,
    iq_to_complex,
    mpsk_map,
    qam_map,
)
from .quantizer import (
    AWGNChannelQuantizer,
    DeviceQuantizerTables,
    QuantizerTables,
    build_quantizer_tables,
    device_tables,
    quantize_llr_with,
    quantize_with,
    sample_clusters_from_uniform,
    sample_clusters_with,
    sample_llrs_from_uniform,
    sample_llrs_with,
)

__all__ = [
    "AWGNChannelQuantizer",
    "Constellation",
    "DeviceQuantizerTables",
    "LDPCTransmitter",
    "QuantizerTables",
    "Transmitter",
    "awgn_transmit",
    "bpsk_map",
    "build_quantizer_tables",
    "demap_llrs",
    "device_tables",
    "ebn0_db_from_sigma2",
    "gray_encoding_table",
    "iq_to_complex",
    "mpsk_bit_llrs",
    "mpsk_map",
    "n0_from_sigma2",
    "qam_bit_llrs",
    "qam_map",
    "quantize_llr_with",
    "quantize_with",
    "sample_clusters_from_uniform",
    "sample_clusters_with",
    "sample_llrs_from_uniform",
    "sample_llrs_with",
    "sigma2_from_ebn0_db",
]
