"""Hand-written Hopper kernels with their plain PyTorch twins.

Importing this package builds nothing: a kernel is compiled and loaded at its
first launch on a CUDA tensor (``_build.load_library``).
"""

from .ib_lut_fused import FusedIBDecoder, ib_lut_decode_tiled, pick_batch_tile

__all__ = ["FusedIBDecoder", "ib_lut_decode_tiled", "pick_batch_tile"]
