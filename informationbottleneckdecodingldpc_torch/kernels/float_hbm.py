"""Float (min-sum / BP) decoder with the message views in device memory: the
Hopper kernel K4 and its plain twin.

Port of ``kernels/float_hbm.py`` (``HBMFloatDecoder``), for codes whose
float32 views do not fit one CTA's shared memory (DVB-S2 N=64800). For a CUDA
tensor the decoder launches the hand-written kernel ``csrc/float_hbm.cu``:
float32 views ``[tile][row][batch_tile]`` in device memory, one launch per
pass over all tiles, early exit per tile. For a CPU tensor it runs the plain
twin :func:`~.float_fused.float_decode_tiled` with the same tile. No CUDA
tensor ever reaches the twin, and a failed build or launch raises.

Exit convention: the port's float decoders (K2, K4 and the plain decoder)
leave a tile right after the body whose VN->CN messages satisfy every check,
and count that body. The JAX ``float_hbm`` kernel tests the syndrome on the
next body's staged CN view, so it leaves one body later and reports one more
iteration; with early exit off the two agree.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..decode.common import DecodeResult
from ..decode.graph_arrays import DecodeLayout
from .float_fused import RULES, FusedFloatDecoder
from .ib_lut_fused import check_channel_input, mean_iterations
from .ib_lut_hbm import HBM_BATCH_TILE, tile_scratch

MAX_DEGREE = 16  # kMaxDegree in csrc/float_hbm.cu


class HBMFloatDecoder(FusedFloatDecoder):
    """Float decoder with device-memory views: LLRs [n_vars, batch] float32
    -> DecodeResult (float32 posterior LLRs).

    ``rule`` is 'minsum' or 'bp'. ``batch_tile`` codewords exit together
    (default 128). ``launches`` counts decodes on the card (the CPU twin does
    not count).
    """

    def __init__(
        self,
        layout: DecodeLayout,
        rule: str = "minsum",
        max_iters: int = 50,
        early_exit: bool = True,
        batch_tile: int | None = None,
    ):
        super().__init__(
            layout,
            rule=rule,
            max_iters=max_iters,
            early_exit=early_exit,
            batch_tile=batch_tile or HBM_BATCH_TILE,
        )

    def _launch(self, channel_llrs: torch.Tensor) -> DecodeResult:
        lay = self.layout
        check_channel_input(channel_llrs, torch.float32, lay, "channel LLRs")
        device = channel_llrs.device
        ch = channel_llrs.contiguous()
        batch = ch.shape[1]
        # With no body to run, the decision reads a zero VN view.
        scratch = tile_scratch(
            lay, batch, self.batch_tile, torch.float32, device, zero_vn_view=self.imax <= 1
        )
        a = self._args(device)
        out = torch.empty((lay.n_vars, batch), dtype=torch.float32, device=device)
        unsat = torch.empty(batch, dtype=torch.int32, device=device)
        iters = torch.empty(batch, dtype=torch.int32, device=device)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            _library().decode(
                RULES[self.rule],
                ch.data_ptr(), out.data_ptr(), unsat.data_ptr(), iters.data_ptr(),
                a["seed_var"].data_ptr(), a["node_var"].data_ptr(),
                a["cn_route"].data_ptr(), a["vn_route"].data_ptr(),
                a["cn_groups"].data_ptr(), a["vn_groups"].data_ptr(),
                *(x.data_ptr() for x in scratch),
                len(lay.cn_groups), len(lay.vn_groups), lay.n_vars, lay.n_checks,
                lay.n_edges, batch, self.batch_tile, self.imax, int(self.early_exit),
                stream,
            )
        self.launches += 1
        return DecodeResult(
            outputs=out,
            iterations=mean_iterations(iters),
            unsatisfied=unsat,
        )


@functools.cache
def _library():
    """K4's library, built at first use."""
    from ._build import KernelLibrary

    p, i = ctypes.c_void_p, ctypes.c_int
    return KernelLibrary("float_hbm", [i] + [p] * 15 + [i] * 9 + [p], MAX_DEGREE)
