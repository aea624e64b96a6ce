"""The headline and float scenarios and throughput measurement."""

from .benchmarks import (
    FLOAT_SCENARIOS,
    HEADLINE,
    build_float_sim,
    build_headline_sim,
    measure_sim_throughput,
)

__all__ = [
    "FLOAT_SCENARIOS",
    "HEADLINE",
    "build_float_sim",
    "build_headline_sim",
    "measure_sim_throughput",
]
