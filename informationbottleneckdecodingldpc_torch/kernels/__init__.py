"""Hand-written Hopper kernels with their plain PyTorch twins.

Importing this package builds nothing: a kernel is compiled and loaded at its
first launch on a CUDA tensor (``_build.load_library``).
"""

from .float_fused import FusedFloatDecoder, float_decode_tiled, pick_float_batch_tile
from .ib_lut_fused import FusedIBDecoder, ib_lut_decode_tiled, pick_batch_tile

__all__ = [
    "FusedFloatDecoder",
    "FusedIBDecoder",
    "float_decode_tiled",
    "ib_lut_decode_tiled",
    "pick_batch_tile",
    "pick_float_batch_tile",
]
