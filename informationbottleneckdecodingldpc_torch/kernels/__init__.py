"""Hand-written Hopper kernels with their plain PyTorch twins: the IB and
float decoders with the message views in shared memory (K1, K2: codes whose
codeword fits one CTA) and in device memory (K3, K4: any code, DVB-S2 N=64800
among them); the roofline's primitive peak chains (K5, ``peaks``) and
device-memory copy (K6, ``hbm_copy``); the probes: packed-LUT column builds
on CUDA cores and tensor cores (P1, ``lut_columns``), reads staged by bulk
copies (P2/P3, ``bulk_read``), the cost of a bulk copy and of a wait
(P4, ``bulk_copies``), the staged 7-plane skeleton of a decode iteration
(P5, ``stage_chunks``) and K3's pass program with the folds replaced (P6,
``stage_replay``); and the Monte-Carlo engine's Philox random planes
(``philox_planes``).

Importing this package builds nothing: a kernel is compiled and loaded at its
first launch on a CUDA tensor (``_build.load_library``).
"""

from .bulk_copies import BulkCopies
from .bulk_read import BulkRead
from .float_fused import FusedFloatDecoder, float_decode_tiled, pick_float_batch_tile
from .float_hbm import HBMFloatDecoder
from .ib_lut_fused import (
    FusedIBDecoder,
    ib_lut_decode_tiled,
    make_fused_ib_decoder,
    pick_batch_tile,
)
from .ib_lut_hbm import HBMFusedIBDecoder
from .lut_columns import columns_chain
from .stage_chunks import StageChunks
from .stage_replay import StageReplay

__all__ = [
    "BulkCopies",
    "BulkRead",
    "FusedFloatDecoder",
    "FusedIBDecoder",
    "HBMFloatDecoder",
    "HBMFusedIBDecoder",
    "StageChunks",
    "StageReplay",
    "columns_chain",
    "float_decode_tiled",
    "ib_lut_decode_tiled",
    "make_fused_ib_decoder",
    "pick_batch_tile",
    "pick_float_batch_tile",
]
