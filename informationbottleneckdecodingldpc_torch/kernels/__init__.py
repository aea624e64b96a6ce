"""Hand-written Hopper kernels with their plain PyTorch twins: the IB and
float decoders with the message views in shared memory (K1, K2: codes whose
codeword fits one CTA) and in device memory (K3, K4: any code, DVB-S2 N=64800
among them); the roofline's primitive peak chains (K5, ``peaks``) and
device-memory copy (K6, ``hbm_copy``).

Importing this package builds nothing: a kernel is compiled and loaded at its
first launch on a CUDA tensor (``_build.load_library``).
"""

from .float_fused import FusedFloatDecoder, float_decode_tiled, pick_float_batch_tile
from .float_hbm import HBMFloatDecoder
from .ib_lut_fused import FusedIBDecoder, ib_lut_decode_tiled, pick_batch_tile
from .ib_lut_hbm import HBMFusedIBDecoder

__all__ = [
    "FusedFloatDecoder",
    "FusedIBDecoder",
    "HBMFloatDecoder",
    "HBMFusedIBDecoder",
    "float_decode_tiled",
    "ib_lut_decode_tiled",
    "pick_batch_tile",
    "pick_float_batch_tile",
]
