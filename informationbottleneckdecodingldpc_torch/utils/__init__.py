"""The headline and the benchmark matrix, its roofline and peak rates,
throughput measurement, and the probes' rates."""

from .benchmarks import (
    HEADLINE,
    MATRIX,
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
    "HEADLINE",
    "MATRIX",
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
