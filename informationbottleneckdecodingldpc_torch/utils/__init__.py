"""The headline, float and DVB-S2 scenarios, the benchmark matrix, its
roofline and peak rates, throughput measurement, and the probes' rates."""

from .benchmarks import (
    DVBS2_SCENARIOS,
    FLOAT_SCENARIOS,
    HEADLINE,
    MATRIX,
    build_dvbs2_sim,
    build_float_sim,
    build_headline_sim,
    build_matrix_sim,
    measure_sim,
    measure_sim_throughput,
)
from .bitpack import pack_bits, unpack_bits
from .probes import (
    measure_columns,
    measure_copies,
    measure_reads,
    measure_replay,
    measure_stage,
)

__all__ = [
    "DVBS2_SCENARIOS",
    "FLOAT_SCENARIOS",
    "HEADLINE",
    "MATRIX",
    "build_dvbs2_sim",
    "build_float_sim",
    "build_headline_sim",
    "build_matrix_sim",
    "measure_columns",
    "measure_copies",
    "measure_reads",
    "measure_replay",
    "measure_sim",
    "measure_sim_throughput",
    "measure_stage",
    "pack_bits",
    "unpack_bits",
]
