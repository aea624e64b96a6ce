"""IB lookup-table decoder with the message views in device memory: the
Hopper kernel K3 and its plain twin.

Port of ``kernels/ib_lut_hbm.py`` (``HBMFusedIBDecoder``), for codes whose
views do not fit one CTA's shared memory (DVB-S2 N=64800). For a CUDA tensor
the decoder launches the hand-written kernel ``csrc/ib_lut_hbm.cu``: uint8
views ``[tile][row][batch_tile]`` in device memory, one launch per pass over
all tiles, early exit per tile, and CN and VN passes in which a thread moves
8 columns of a view row per access (``csrc/hbm_wide.cuh``) and reads the
pairwise tables from a copy per lane. When the tables give |T_ch| <= 16 and
|T| <= 16 (:func:`view_bits`), every message is 4 bits and the views and the
channel plane hold two codeword columns a byte (column 2k in the low nibble
of byte k, 2k + 1 in its high nibble), which halves the view traffic of
every body; otherwise one a byte. The kernel takes tiles of up to
:data:`HBM_MAX_TILE` codewords that 8 divides; :meth:`~HBMFusedIBDecoder.check_tile`
refuses any other tile before the card is touched. For a CPU tensor it runs the plain twin
:func:`~.ib_lut_fused.ib_lut_decode_tiled` with the same tile. The two agree
bit for bit: outputs in natural variable order, per-codeword unsatisfied
counts and the mean iteration count. No CUDA tensor ever reaches the twin, and
a failed build or launch raises.

It takes any layout (WLAN too): on Hopper a route is an int32 row index, so
the JAX kernel's unit-stride routing requirement (``hbm_supported``) and its
DMA chassis have no counterpart here.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..construct.trellis import TrellisTables
from ..decode.common import DecodeResult
from ..decode.graph_arrays import DecodeLayout
from .ib_lut_fused import (
    FusedIBDecoder,
    _slot,
    check_channel_input,
    mean_iterations,
)

MAX_DEGREE = 16  # kMaxDegree in csrc/ib_lut_hbm.cu
# The default tile: 128 codewords make each routed row write 128 contiguous
# bytes (four full 32-byte sectors) and keep 8 tiles in flight at batch 1024.
HBM_BATCH_TILE = 128
# The largest tile of K3's and K4's wide passes (kMaxTile in
# csrc/hbm_wide.cuh): a row of 4-column items fills a block of 256 threads.
HBM_MAX_TILE = 1024
# Columns per thread and view row of K3's per-lane passes (kVec in
# csrc/ib_lut_hbm.cu): 80 registers on bytes; 16 took 128 and 4 ran slower.
K3_VEC = 8
# The largest |T| and |T_ch| whose messages K3's views hold at 4 bits
# (kPackedT in csrc/ib_lut_hbm.cu).
PACKED_T = 16


def view_bits(t_channel: int, t_decoder: int) -> int:
    """Bits per message of K3's views for tables of |T_ch| = ``t_channel``
    and |T| = ``t_decoder``: 4 when both are at most :data:`PACKED_T`, else 8."""
    return 4 if max(t_channel, t_decoder) <= PACKED_T else 8


def check_wide_tile(batch_tile: int, vec: int) -> None:
    """Refuse a tile the wide kernels do not take: ``vec`` columns per
    thread must divide it, and it holds at most :data:`HBM_MAX_TILE`
    codewords."""
    if batch_tile % vec:
        raise ValueError(
            f"{vec} columns per thread do not divide batch_tile {batch_tile}"
        )
    if not 0 < batch_tile <= HBM_MAX_TILE:
        raise ValueError(
            f"the device-memory kernels take tiles of at most {HBM_MAX_TILE} "
            f"codewords, not {batch_tile}"
        )


def check_view_tile(layout: DecodeLayout, batch_tile: int) -> None:
    """The kernels index one tile's view with int32: refuse a tile whose
    ``n_edges * batch_tile`` elements overflow it."""
    if layout.n_edges * batch_tile >= 2**31:
        raise ValueError(
            f"a tile of {batch_tile} codewords has {layout.n_edges * batch_tile} "
            "view elements, more than int32 indexing takes"
        )


def tile_scratch(
    layout: DecodeLayout,
    batch: int,
    batch_tile: int,
    dtype: torch.dtype,
    device: torch.device,
    zero_vn_view: bool = False,
    vn_views: int = 1,
    packed: bool = False,
) -> tuple[torch.Tensor, ...]:
    """K3's and K4's scratch for ``batch`` codewords in tiles of
    ``batch_tile``: the CN view [n_tiles, n_edges, tile], the VN view of
    the same shape (K3) or ``vn_views`` of them stacked in front (K4's two,
    [2, n_tiles, n_edges, tile]), and the channel plane [n_tiles, n_vars,
    tile] of ``dtype``, then per tile the int32 unsat counts [n_tiles, tile]
    and state [n_tiles, 2]. ``packed`` (K3 at 4 bits a message): the views'
    and the plane's rows hold tile / 2 bytes."""
    n_tiles = -(-batch // batch_tile)
    row = batch_tile // 2 if packed else batch_tile
    views = (n_tiles, layout.n_edges, row)
    vn_shape = views if vn_views == 1 else (vn_views, *views)
    new = functools.partial(torch.empty, device=device)
    return (
        new(views, dtype=dtype),
        (torch.zeros if zero_vn_view else torch.empty)(vn_shape, dtype=dtype, device=device),
        new((n_tiles, layout.n_vars, row), dtype=dtype),
        new((n_tiles, batch_tile), dtype=torch.int32),
        new((n_tiles, 2), dtype=torch.int32),
    )


class HBMFusedIBDecoder(FusedIBDecoder):
    """IB decoder with device-memory views: clusters [n_vars, batch] int32
    -> DecodeResult.

    ``batch_tile`` codewords exit together (default 128; the card takes
    multiples of 8 up to :data:`HBM_MAX_TILE`, the CPU twin any tile).
    Tables, checks and the CPU twin are :class:`FusedIBDecoder`'s;
    ``launches`` counts decodes on the card and ``packed_launches`` those of
    them on 4-bit views (``view_bits``, from the tables); the CPU twin counts
    neither.
    """

    def __init__(
        self,
        layout: DecodeLayout,
        tables: TrellisTables,
        max_iters: int | None = None,
        early_exit: bool = True,
        use_matching: bool = True,
        batch_tile: int | None = None,
    ):
        super().__init__(
            layout,
            tables,
            max_iters=max_iters,
            early_exit=early_exit,
            use_matching=use_matching,
            batch_tile=batch_tile or HBM_BATCH_TILE,
        )
        self.view_bits = view_bits(
            tables.cardinality_t_channel, tables.cardinality_t_decoder
        )
        self.packed_launches = 0

    def check_tile(self) -> None:
        """Raise ValueError if the card's kernel does not take ``batch_tile``."""
        check_view_tile(self.layout, self.batch_tile)
        check_wide_tile(self.batch_tile, K3_VEC)

    def _launch(self, channel_clusters: torch.Tensor) -> DecodeResult:
        lay = self.layout
        check_channel_input(channel_clusters, torch.int32, lay, "channel clusters")
        self.check_tile()
        bt = self.batch_tile
        device = channel_clusters.device
        ch = channel_clusters.contiguous()
        batch = ch.shape[1]
        packed = self.view_bits == 4
        scratch = tile_scratch(lay, batch, bt, torch.uint8, device, packed=packed)
        a = self._args(device)
        out = torch.empty((lay.n_vars, batch), dtype=torch.int32, device=device)
        unsat = torch.empty(batch, dtype=torch.int32, device=device)
        iters = torch.empty(batch, dtype=torch.int32, device=device)
        t = self.tables
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            _library().decode(
                ch.data_ptr(), out.data_ptr(), unsat.data_ptr(), iters.data_ptr(),
                a["cn_tab"].data_ptr(), a["vn_tab"].data_ptr(),
                a["match_cn"].data_ptr(), a["match_vn"].data_ptr(),
                a["seed_var"].data_ptr(), a["node_var"].data_ptr(),
                a["cn_route"].data_ptr(), a["vn_route"].data_ptr(),
                a["cn_groups"].data_ptr(), a["vn_groups"].data_ptr(),
                *(x.data_ptr() for x in scratch),
                len(lay.cn_groups), len(lay.vn_groups), lay.n_vars, lay.n_checks,
                lay.n_edges, batch, bt,
                t.cardinality_t_channel, t.cardinality_t_decoder,
                max(lay.d_c_max - 2, 1), lay.d_v_max,
                _slot(t.cardinality_t_channel, t.cardinality_t_decoder),
                lay.d_c_max, lay.d_v_max, self.imax, int(self.early_exit),
                self.view_bits, stream,
            )
        self.launches += 1
        self.packed_launches += packed
        return DecodeResult(
            outputs=out,
            iterations=mean_iterations(iters),
            unsatisfied=unsat,
        )


@functools.cache
def _library():
    """K3's library, built at first use."""
    from ._build import KernelLibrary

    p, i = ctypes.c_void_p, ctypes.c_int
    return KernelLibrary(
        "ib_lut_hbm", [p] * 19 + [i] * 17 + [p], MAX_DEGREE, vec=K3_VEC, max_tile=HBM_MAX_TILE,
        packed_t=PACKED_T,
    )
