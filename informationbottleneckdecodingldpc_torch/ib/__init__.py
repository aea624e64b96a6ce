"""The exact symmetric information-bottleneck quantizer of the channel
output and the mutual information it needs: the port's copies of the JAX
package's numpy-only ``ib/dp_quantizer.py`` and ``ib/tools.py``. The
sequential IB and decoder construction stay host-only in the JAX package."""

from .dp_quantizer import optimal_symmetric_quantizer, partial_mi_table
from .tools import kl_divergence, mutual_information, numerical_guard

__all__ = [
    "kl_divergence",
    "mutual_information",
    "numerical_guard",
    "optimal_symmetric_quantizer",
    "partial_mi_table",
]
