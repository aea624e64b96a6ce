"""The headline scenario and throughput measurement."""

from .benchmarks import HEADLINE, build_headline_sim, measure_sim_throughput

__all__ = ["HEADLINE", "build_headline_sim", "measure_sim_throughput"]
