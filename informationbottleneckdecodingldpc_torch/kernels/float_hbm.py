"""Float (min-sum / BP) decoder with the message views in device memory: the
Hopper kernel K4 and its plain twin.

Port of ``kernels/float_hbm.py`` (``HBMFloatDecoder``), for codes whose
float32 views do not fit one CTA's shared memory (DVB-S2 N=64800). For a CUDA
tensor the decoder launches the hand-written kernel ``csrc/float_hbm.cu``:
float32 views ``[tile][row][batch_tile]`` in device memory (the CN->VN view
twice, for even and odd bodies), one launch per pass over all tiles, early
exit per tile, the syndrome counted inside the CN pass, and CN and VN passes
in which a thread moves four floats of a view row per access. The kernel
takes tiles of up to ``HBM_MAX_TILE`` codewords that 4 divides;
:meth:`~HBMFloatDecoder.check_tile` refuses any other tile before the card
is touched. For a CPU tensor it runs the plain twin :func:`~.float_fused.float_decode_tiled` with the same tile. No CUDA
tensor ever reaches the twin, and a failed build or launch raises.

Exit convention: the port's float decoders (K2, K4 and the plain decoder)
leave a tile right after the body whose VN->CN messages satisfy every check,
and count that body. K4 counts that syndrome in the next body's CN pass,
which writes the other CN->VN view, so the decision still reads the exit
body's. The JAX ``float_hbm`` kernel tests the syndrome on the next body's
staged CN view and keeps that body's messages, so it leaves one body later
and reports one more iteration; with early exit off the two agree.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..decode.common import DecodeResult
from ..decode.graph_arrays import DecodeLayout
from .float_fused import RULES, FusedFloatDecoder
from .ib_lut_fused import check_channel_input, mean_iterations
from .ib_lut_hbm import (
    HBM_BATCH_TILE,
    HBM_MAX_TILE,
    check_view_tile,
    check_wide_tile,
    tile_scratch,
)

MAX_DEGREE = 16  # kMaxDegree in csrc/float_hbm.cu
K4_VEC = 4  # floats per thread and view row of the CN and VN passes (kVec)


class HBMFloatDecoder(FusedFloatDecoder):
    """Float decoder with device-memory views: LLRs [n_vars, batch] float32
    -> DecodeResult (float32 posterior LLRs).

    ``rule`` is 'minsum' or 'bp'. ``batch_tile`` codewords exit together
    (default 128; the card takes multiples of 4 up to ``HBM_MAX_TILE``, the
    CPU twin any tile). ``launches`` counts decodes on the card (the CPU
    twin does not count).
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

    def check_tile(self) -> None:
        """Raise ValueError if the card's kernel does not take ``batch_tile``."""
        check_view_tile(self.layout, self.batch_tile)
        check_wide_tile(self.batch_tile, K4_VEC)

    def _launch(self, channel_llrs: torch.Tensor) -> DecodeResult:
        lay = self.layout
        check_channel_input(channel_llrs, torch.float32, lay, "channel LLRs")
        self.check_tile()
        device = channel_llrs.device
        ch = channel_llrs.contiguous()
        batch = ch.shape[1]
        # With no body to run, the decision reads a zero VN view.
        scratch = tile_scratch(
            lay, batch, self.batch_tile, torch.float32, device,
            zero_vn_view=self.imax <= 1, vn_views=2,
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
                lay.n_edges, batch, self.batch_tile, lay.d_c_max, lay.d_v_max,
                self.imax, int(self.early_exit), stream,
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
    return KernelLibrary(
        "float_hbm", [i] + [p] * 15 + [i] * 11 + [p], MAX_DEGREE, vec=K4_VEC, max_tile=HBM_MAX_TILE
    )
