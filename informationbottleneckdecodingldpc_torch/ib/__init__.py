"""Information-bottleneck algorithms and the information-theory tools they
need: the port's copies of the JAX package's numpy-only ``ib/dp_quantizer.py``
(the exact symmetric quantizer), ``ib/sib.py`` (the sequential IB classes)
and ``ib/tools.py``."""

from .dp_quantizer import optimal_symmetric_quantizer, partial_mi_table
from .sib import LinSymSIB, SymmetricSIB, sequential_sib
from .tools import kl_divergence, mutual_information, numerical_guard

__all__ = [
    "LinSymSIB",
    "SymmetricSIB",
    "kl_divergence",
    "mutual_information",
    "numerical_guard",
    "optimal_symmetric_quantizer",
    "partial_mi_table",
    "sequential_sib",
]
