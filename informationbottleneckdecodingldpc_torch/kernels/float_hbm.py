"""Float (min-sum / BP) decoder with its message state in device memory:
the Hopper kernel K4 and its plain twin.

Port of ``kernels/float_hbm.py`` (``HBMFloatDecoder``), for codes whose
float32 views do not fit one CTA's shared memory (DVB-S2 N=64800). For a CUDA
tensor the decoder launches the hand-written kernel ``csrc/float_hbm.cu`` on
one of two paths, chosen from what the decoder observes (:func:`takes_node_state`):

- min-sum where every check has degree 3 to :data:`STATE_MAX_DEGREE`: the
  node-state path. Each check keeps one record of 10 bytes a codeword (the
  magnitude of its output at its least input and at the others, the sign of
  each output and the least input's slot, from which every output is
  rebuilt bit for bit) and each variable its total, so a body moves less
  than half the device-memory bytes of three float32 views per edge. The
  passes walk slices of
  :func:`state_slice` columns one after another, so that the gathered
  records and totals of the live slice stay in L2;
- BP, and min-sum with a degree-2 check (which min-sum passes through raw) or
  a check too wide for the code word: the view path, float32 views
  ``[tile][row][batch_tile]`` in device memory (the CN->VN view twice, for
  even and odd bodies) moved four floats a thread per access.

Both launch one kernel per pass over all tiles, exit early per tile and count
the syndrome inside the CN pass. The kernel takes tiles of up to
``HBM_MAX_TILE`` codewords that 4 divides; :meth:`~HBMFloatDecoder.check_tile`
refuses any other tile before the card is touched. For a CPU tensor it runs
the plain twin :func:`~.float_fused.float_decode_tiled` with the same tile.
No CUDA tensor ever reaches the twin, and a failed build or launch raises.

Exit convention: the port's float decoders (K2, K4 and the plain decoder)
leave a tile right after the body whose VN->CN messages satisfy every check,
and count that body. K4 counts that syndrome in the next body's CN pass; a
tile that leaves skips that body's VN pass, so the decision still reads the
exit body's posterior (on the view path, the other CN->VN view). The JAX
``float_hbm`` kernel tests the syndrome on the next body's staged CN view and
keeps that body's messages, so it leaves one body later and reports one more
iteration; with early exit off the two agree.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..decode.common import DecodeResult
from ..decode.graph_arrays import DecodeLayout
from .float_fused import RULES, FusedFloatDecoder
from .ib_lut_fused import check_channel_input, device_arrays, mean_iterations
from .ib_lut_hbm import (
    HBM_BATCH_TILE,
    HBM_MAX_TILE,
    check_view_tile,
    check_wide_tile,
    tile_scratch,
)

MAX_DEGREE = 16  # kMaxDegree in csrc/float_hbm.cu
K4_VEC = 4  # floats per thread and view row of the CN and VN passes (kVec)
# The widest check of the node-state path: a 16-bit record code holds a sign
# bit per edge and the 4-bit argmin slot (kStateMaxDegree).
STATE_MAX_DEGREE = 12
# Columns of a slice of the node-state path: at 32, a DVB-S2 slice's records
# (10.4 MB) and totals (8.3 MB) fit the card's 50 MB L2 together; 16 and 64
# ran slower on an H100, 8 far slower.
STATE_SLICE = 32
SLOT_BITS = 4  # vn_check holds check << SLOT_BITS | slot (kSlotBits)


def takes_node_state(layout: DecodeLayout, rule: str) -> bool:
    """Whether K4 decodes ``layout`` on its node-state path: min-sum, every
    check of degree 3 to :data:`STATE_MAX_DEGREE`."""
    degrees = [g.degree for g in layout.cn_groups]
    return rule == "minsum" and min(degrees) >= 3 and max(degrees) <= STATE_MAX_DEGREE


def state_slice(batch_tile: int, columns: int) -> int:
    """Columns of a node-state slice in tiles of ``batch_tile``: the widest
    multiple of :data:`K4_VEC` up to ``columns`` that divides the tile."""
    return max(
        s for s in range(K4_VEC, min(columns, batch_tile) + 1, K4_VEC) if batch_tile % s == 0
    )


def state_arrays(layout: DecodeLayout) -> dict[str, np.ndarray]:
    """The node-state path's index arrays (int32): ``cn_var``, per CN-view
    row the position of its variable in group order (``~position`` for a
    degree-1 variable, which forwards its channel LLR), and ``vn_check``,
    per VN-view row its check's position in group order times
    2**:data:`SLOT_BITS` plus the row's slot in that check."""
    degree = np.concatenate([np.full(g.num_nodes, g.degree) for g in layout.vn_groups])
    position = np.asarray(layout.vn_node_unperm, dtype=np.int64)[layout.cn_edge_var]
    cn_var = np.where(degree[position] == 1, ~position, position)
    check_slot = np.empty(layout.n_edges, dtype=np.int64)
    first = 0
    for g in layout.cn_groups:
        q = np.arange(g.degree * g.num_nodes)
        check_slot[g.offset + q] = (first + q % g.num_nodes) << SLOT_BITS | q // g.num_nodes
        first += g.num_nodes
    return {
        "cn_var": cn_var.astype(np.int32),
        "vn_check": check_slot[layout.vn_to_cn_row].astype(np.int32),
    }


def state_scratch(
    layout: DecodeLayout, batch: int, batch_tile: int, slice_columns: int, device: torch.device
) -> tuple[torch.Tensor, ...]:
    """The node-state path's scratch for ``batch`` codewords in tiles of
    ``batch_tile``, in slices of ``slice_columns`` ([n_slices, nodes,
    slice_columns], a tile's slices in turn): per check the record's two
    magnitudes (float32) and its code (int16, read as uint16), per variable
    the total and the channel LLR (float32); then per tile the int32 unsat
    counts [n_tiles, tile] and state [n_tiles, 2]."""
    n_tiles = -(-batch // batch_tile)
    n_slices = n_tiles * (batch_tile // slice_columns)
    checks = (n_slices, layout.n_checks, slice_columns)
    variables = (n_slices, layout.n_vars, slice_columns)
    new = functools.partial(torch.empty, device=device)
    return (
        new(checks, dtype=torch.float32),
        new(checks, dtype=torch.float32),
        new(checks, dtype=torch.int16),
        new(variables, dtype=torch.float32),
        new(variables, dtype=torch.float32),
        new((n_tiles, batch_tile), dtype=torch.int32),
        new((n_tiles, 2), dtype=torch.int32),
    )


class HBMFloatDecoder(FusedFloatDecoder):
    """Float decoder with its message state in device memory: LLRs [n_vars,
    batch] float32 -> DecodeResult (float32 posterior LLRs).

    ``rule`` is 'minsum' or 'bp'. ``batch_tile`` codewords exit together
    (default 128; the card takes multiples of 4 up to ``HBM_MAX_TILE``, the
    CPU twin any tile). ``node_state`` says whether the card runs the
    node-state path (:func:`takes_node_state`), in slices of
    ``slice_columns`` columns (:data:`STATE_SLICE`, cut to a divisor of the
    tile); a measurement may set either, to run the view path on the same
    layout or another slice. ``launches`` counts decodes on the card and
    ``state_launches`` those of them on the node-state path; the CPU twin
    counts neither.
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
        self.node_state = takes_node_state(layout, rule)
        self.slice_columns = STATE_SLICE
        self.state_launches = 0

    def check_tile(self) -> None:
        """Raise ValueError if the card's kernel does not take ``batch_tile``."""
        check_view_tile(self.layout, self.batch_tile)
        check_wide_tile(self.batch_tile, K4_VEC)

    def _args(self, device: torch.device) -> dict:
        if device not in self._kernel_args:
            super()._args(device)
            self._kernel_args[device].update(
                device_arrays(state_arrays(self.layout), device)
            )
        return self._kernel_args[device]

    def _launch(self, channel_llrs: torch.Tensor) -> DecodeResult:
        lay = self.layout
        check_channel_input(channel_llrs, torch.float32, lay, "channel LLRs")
        self.check_tile()
        bt = self.batch_tile
        device = channel_llrs.device
        ch = channel_llrs.contiguous()
        batch = ch.shape[1]
        if self.node_state:
            columns = state_slice(bt, self.slice_columns)
            *state, unsat_scratch, tiles = state_scratch(lay, batch, bt, columns, device)
            views = (None, None, None)
        else:
            # With no body to run, the decision reads a zero VN view.
            columns, state = 0, (None,) * 5
            *views, unsat_scratch, tiles = tile_scratch(
                lay, batch, bt, torch.float32, device,
                zero_vn_view=self.imax <= 1, vn_views=2,
            )
        a = self._args(device)
        out = torch.empty((lay.n_vars, batch), dtype=torch.float32, device=device)
        unsat = torch.empty(batch, dtype=torch.int32, device=device)
        iters = torch.empty(batch, dtype=torch.int32, device=device)
        ptr = lambda x: None if x is None else x.data_ptr()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            _library().decode(
                RULES[self.rule],
                ch.data_ptr(), out.data_ptr(), unsat.data_ptr(), iters.data_ptr(),
                a["seed_var"].data_ptr(), a["node_var"].data_ptr(),
                a["cn_route"].data_ptr(), a["vn_route"].data_ptr(),
                a["cn_groups"].data_ptr(), a["vn_groups"].data_ptr(),
                *(ptr(x) for x in views), unsat_scratch.data_ptr(), tiles.data_ptr(),
                *(ptr(x) for x in state),
                a["cn_var"].data_ptr(), a["vn_check"].data_ptr(),
                len(lay.cn_groups), len(lay.vn_groups), lay.n_vars, lay.n_checks,
                lay.n_edges, batch, bt, columns, lay.d_c_max, lay.d_v_max,
                self.imax, int(self.early_exit), stream,
            )
        self.launches += 1
        self.state_launches += bool(columns)
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
        "float_hbm", [i] + [p] * 22 + [i] * 12 + [p], MAX_DEGREE, vec=K4_VEC,
        max_tile=HBM_MAX_TILE, state_max_degree=STATE_MAX_DEGREE,
    )
