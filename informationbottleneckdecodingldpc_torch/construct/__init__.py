"""Offline decoder construction (the port's numpy copy of the JAX package's
``construct/``): density evolution, message alignment, trellis tables and
the saved decoder configs."""

from .awgn_dde import DecoderConfig, build_decoder_config
from .density_evolution import DiscreteDensityEvolution
from .density_evolution_irreg import DiscreteDensityEvolutionIrregular
from .matching import information_matching
from .trellis import TrellisTables

__all__ = [
    "DecoderConfig",
    "DiscreteDensityEvolution",
    "DiscreteDensityEvolutionIrregular",
    "TrellisTables",
    "build_decoder_config",
    "information_matching",
]
