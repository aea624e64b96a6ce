"""Fused float (min-sum / BP) decoder: the Hopper kernel K2 and its twin.

Port of ``kernels/float_fused.py`` (``FusedFloatDecoder``). For a CUDA tensor
the decoder launches the hand-written kernel ``csrc/float_fused.cu`` (one CTA
per tile of ``batch_tile`` codewords, both float32 message views in shared
memory, early exit per tile; a body is a CN pass that also takes the
syndrome of its inputs and a VN pass that also writes the decision); for a
CPU tensor it runs the plain twin
:func:`float_decode_tiled`, which applies the whole-batch decoder to each
zero-padded tile. No CUDA tensor ever reaches the twin, and a failed build
or launch raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..decode.bp import belief_propagation_decode
from ..decode.common import DecodeResult
from ..decode.graph_arrays import DecodeLayout
from ..decode.min_sum import min_sum_decode
from .ib_lut_fused import (
    MAX_SHARED_BYTES,
    check_channel_input,
    decode_in_tiles,
    device_arrays,
    layout_arrays,
    mean_iterations,
)

MAX_DEGREE = 16  # kMaxDegree in csrc/float_fused.cu
# kThreads per rule: a CTA runs (THREADS[rule] // batch_tile) * batch_tile
# threads, so each keeps one codeword column for the whole decode.
THREADS = {"minsum": 1024, "bp": 640}
# Small codes would fit a hundred codewords per CTA; 32 keeps batches of a
# few thousand spread over all 132 SMs.
MAX_BATCH_TILE = 32
RULES = {"minsum": 0, "bp": 1}  # the kernel's rule argument
DECODERS = {"minsum": min_sum_decode, "bp": belief_propagation_decode}


def shared_bytes(layout: DecodeLayout, batch_tile: int) -> int:
    """Shared memory of one CTA; mirrors ``shared_bytes`` in the .cu file:
    per-codeword unsat counts (int32), then the CN and VN views and the
    channel LLRs as float32."""
    return 4 * batch_tile + 4 * (2 * layout.n_edges + layout.n_vars) * batch_tile


def pick_float_batch_tile(layout: DecodeLayout) -> int:
    """Largest tile of at most 32 codewords whose CTA fits 227 KB."""
    per_codeword = shared_bytes(layout, 1)
    bt = min(MAX_SHARED_BYTES // per_codeword, MAX_BATCH_TILE)
    if bt < 1:
        raise ValueError(
            f"layout does not fit one CTA's shared memory even with one "
            f"codeword ({per_codeword} bytes > {MAX_SHARED_BYTES})"
        )
    return bt


def float_decode_tiled(
    layout: DecodeLayout,
    channel_llrs: torch.Tensor,
    rule: str,
    batch_tile: int,
    max_iters: int,
    early_exit: bool = True,
) -> DecodeResult:
    """Plain twin of K2: the whole-batch min-sum or BP decoder on each
    tile."""
    decode = DECODERS[rule]
    return decode_in_tiles(
        lambda ch: decode(layout, ch, max_iters, early_exit=early_exit),
        channel_llrs,
        batch_tile,
    )


class FusedFloatDecoder:
    """Tiled float decoder: LLRs [n_vars, batch] float32 -> DecodeResult
    (float32 posterior LLRs).

    ``rule`` is 'minsum' or 'bp'. ``batch_tile`` codewords share one CTA
    and exit together; the default is the largest tile that fits shared
    memory. ``launches`` counts kernel launches (the CPU twin does not
    count).
    """

    def __init__(
        self,
        layout: DecodeLayout,
        rule: str = "minsum",
        max_iters: int = 50,
        early_exit: bool = True,
        batch_tile: int | None = None,
    ):
        if rule not in RULES:
            raise ValueError(f"unknown rule {rule!r}")
        degrees = [g.degree for g in layout.cn_groups + layout.vn_groups]
        if max(degrees) > MAX_DEGREE or min(g.degree for g in layout.cn_groups) < 2:
            raise ValueError(
                f"the kernel takes node degrees up to {MAX_DEGREE} and check "
                "degrees of at least 2"
            )
        self.layout = layout
        self.rule = rule
        self.imax = int(max_iters)
        self.early_exit = bool(early_exit)
        # A tile larger than shared memory holds runs on the CPU twin (a
        # test may set it to the whole batch) and is refused at launch.
        self.batch_tile = int(batch_tile or pick_float_batch_tile(layout))
        self.launches = 0
        self._kernel_args: dict[torch.device, dict] = {}

    def __call__(self, channel_llrs: torch.Tensor) -> DecodeResult:
        device = channel_llrs.device
        if device.type == "cpu":
            return float_decode_tiled(
                self.layout,
                channel_llrs,
                self.rule,
                self.batch_tile,
                self.imax,
                early_exit=self.early_exit,
            )
        if device.type != "cuda":
            raise ValueError(f"no kernel for device {device}")
        return self._launch(channel_llrs)

    # -- kernel -----------------------------------------------------------
    def _args(self, device: torch.device) -> dict:
        if device not in self._kernel_args:
            self._kernel_args[device] = device_arrays(
                layout_arrays(self.layout), device
            )
        return self._kernel_args[device]

    def _launch(self, channel_llrs: torch.Tensor) -> DecodeResult:
        lay = self.layout
        check_channel_input(channel_llrs, torch.float32, lay, "channel LLRs")
        if shared_bytes(lay, self.batch_tile) > MAX_SHARED_BYTES:
            raise ValueError(
                f"a tile of {self.batch_tile} codewords needs "
                f"{shared_bytes(lay, self.batch_tile)} bytes of shared "
                f"memory, more than {MAX_SHARED_BYTES}"
            )
        device = channel_llrs.device
        ch = channel_llrs.contiguous()
        batch = ch.shape[1]
        a = self._args(device)
        out = torch.empty((lay.n_vars, batch), dtype=torch.float32, device=device)
        tiles = -(-batch // self.batch_tile)
        totals = torch.empty(
            tiles * lay.n_vars * self.batch_tile, dtype=torch.float32, device=device
        )
        unsat = torch.empty(batch, dtype=torch.int32, device=device)
        iters = torch.empty(batch, dtype=torch.int32, device=device)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            _library().decode(
                RULES[self.rule],
                ch.data_ptr(), out.data_ptr(), totals.data_ptr(),
                unsat.data_ptr(), iters.data_ptr(),
                a["seed_var"].data_ptr(), a["node_var"].data_ptr(),
                a["cn_route"].data_ptr(), a["vn_route"].data_ptr(),
                a["cn_groups"].data_ptr(), a["vn_groups"].data_ptr(),
                len(lay.cn_groups), len(lay.vn_groups), lay.n_vars, lay.n_edges,
                batch, self.batch_tile, self.imax, int(self.early_exit),
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
    """K2's library, built at first use."""
    from ._build import KernelLibrary

    p, i = ctypes.c_void_p, ctypes.c_int
    return KernelLibrary(
        "float_fused", [i] + [p] * 11 + [i] * 8 + [p], MAX_DEGREE,
        threads_minsum=THREADS["minsum"], threads_bp=THREADS["bp"],
    )
