"""The headline, float and DVB-S2 scenarios and throughput measurement."""

from .benchmarks import (
    DVBS2_SCENARIOS,
    FLOAT_SCENARIOS,
    HEADLINE,
    build_dvbs2_sim,
    build_float_sim,
    build_headline_sim,
    measure_sim_throughput,
)

__all__ = [
    "DVBS2_SCENARIOS",
    "FLOAT_SCENARIOS",
    "HEADLINE",
    "build_dvbs2_sim",
    "build_float_sim",
    "build_headline_sim",
    "measure_sim_throughput",
]
