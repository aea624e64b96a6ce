"""Fused IB lookup-table decoder: the Hopper kernel K1 and its plain twin.

Port of ``kernels/ib_lut_fused.py`` (``FusedIBDecoder``). For a CUDA tensor
the decoder launches the hand-written kernel ``csrc/ib_lut_fused.cu`` (one
CTA per tile of ``batch_tile`` codewords, both message views in shared
memory, early exit per tile; the routes in shared memory as uint16 where
they fit, :func:`kernel_shared_bytes`; each pass walked flat over its
degree groups by threads of :func:`columns_per_thread` codeword columns);
for a CPU tensor it runs the plain twin
:func:`ib_lut_decode_tiled`, which applies the whole-batch decoder to each
zero-padded tile. The two agree bit for bit: outputs, per-codeword
unsatisfied counts and the mean iteration count. No CUDA tensor ever reaches
the twin, and a failed build or launch raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable

import numpy as np
import torch

from ..construct.trellis import TrellisTables
from ..decode.common import DecodeResult
from ..decode.graph_arrays import DecodeLayout
from ..decode.ib_lut import DeviceTrellis, ib_lut_decode

# Dynamic shared memory one block may use on Hopper (227 KB).
MAX_SHARED_BYTES = 232_448
MAX_DEGREE = 16  # kMaxDegree in csrc/ib_lut_fused.cu
BATCH_TILES = (32, 16, 8, 4, 2, 1)
# K1's threads per CTA at 4 and at 1 codeword columns per thread (kThreads in
# csrc/ib_lut_fused.cu).
THREADS = {4: 640, 1: 1024}


def _slot(t_channel: int, t_decoder: int) -> int:
    return max(t_channel, t_decoder) ** 2


def columns_per_thread(batch_tile: int) -> int:
    """Codeword columns of one K1 thread: 4 where 4 divides the tile."""
    return 4 if batch_tile % 4 == 0 else 1


def threads_per_cta(batch_tile: int) -> int:
    """K1's threads per CTA: whole node rows of tile / V threads each."""
    v = columns_per_thread(batch_tile)
    lanes = batch_tile // v
    return THREADS[v] // lanes * lanes


def shared_bytes(
    layout: DecodeLayout, batch_tile: int, t_channel: int, t_decoder: int
) -> int:
    """Shared memory of one CTA before K1's routes (the tile rule);
    mirrors ``carve_bytes`` in the .cu file: per-codeword unsat counts (two
    int buffers), the CN and VN views and the channel clusters as bytes, one
    iteration's CN and VN LUTs and alignment rows."""
    n_cn_slots = max(layout.d_c_max - 2, 1)
    n_vn_slots = layout.d_v_max
    return (
        2 * 4 * batch_tile
        + (2 * layout.n_edges + layout.n_vars) * batch_tile
        + (n_cn_slots + n_vn_slots) * _slot(t_channel, t_decoder)
        + (layout.d_c_max + layout.d_v_max) * t_decoder
    )


def kernel_shared_bytes(
    layout: DecodeLayout, batch_tile: int, t_channel: int, t_decoder: int
) -> tuple[int, bool]:
    """K1's own carve, as ``shared_bytes`` in the .cu file: the tile rule's
    :func:`shared_bytes`, then the routes as uint16 (2-byte aligned) where
    they fit in :data:`MAX_SHARED_BYTES` and the layout has at most 65536
    edges. Returns the bytes and whether the routes are in shared memory.
    The tile rule (:func:`pick_batch_tile`) does not follow it."""
    carve = shared_bytes(layout, batch_tile, t_channel, t_decoder)
    routes = -(-carve // 2) * 2 + 4 * layout.n_edges
    if layout.n_edges <= 65536 and routes <= MAX_SHARED_BYTES:
        return routes, True
    return carve, False


def pick_batch_tile(
    layout: DecodeLayout, t_channel: int, t_decoder: int
) -> int:
    """Largest tile of 32/16/8/4/2/1 codewords whose CTA fits 227 KB."""
    for bt in BATCH_TILES:
        if shared_bytes(layout, bt, t_channel, t_decoder) <= MAX_SHARED_BYTES:
            return bt
    raise ValueError(
        f"layout does not fit one CTA's shared memory even with one codeword "
        f"({shared_bytes(layout, 1, t_channel, t_decoder)} bytes > "
        f"{MAX_SHARED_BYTES}); codes this large need the global-memory kernel"
    )


def mean_iterations(per_codeword: torch.Tensor) -> torch.Tensor:
    """Float32 mean of per-codeword iteration counts, computed as the JAX
    package's ``jnp.mean`` is: the (exact) sum times the float32 reciprocal
    of the count, so both report the same float bit for bit."""
    # torch.full fills on the device; a tensor made from a host scalar
    # would be a pageable copy that blocks the host until the stream drains.
    inv = torch.full(
        (), 1.0 / per_codeword.numel(), dtype=torch.float32,
        device=per_codeword.device,
    )
    return per_codeword.to(torch.float32).sum() * inv


def decode_in_tiles(
    decode: Callable[[torch.Tensor], DecodeResult],
    channel: torch.Tensor,
    batch_tile: int,
) -> DecodeResult:
    """A whole-batch ``decode`` run on each zero-padded tile of
    ``batch_tile`` columns, so each tile exits early on its own (padding
    included), as a fused kernel's CTA does; ``iterations`` is the mean over
    the real codewords."""
    batch = channel.shape[-1]
    pad = (-batch) % batch_tile
    ch = torch.nn.functional.pad(channel, (0, pad))
    outs, unsats, iters = [], [], []
    for b0 in range(0, batch + pad, batch_tile):
        r = decode(ch[:, b0 : b0 + batch_tile])
        outs.append(r.outputs)
        unsats.append(r.unsatisfied)
        iters.append(r.iterations.expand(batch_tile))
    return DecodeResult(
        outputs=torch.cat(outs, dim=1)[:, :batch],
        iterations=mean_iterations(torch.cat(iters)[:batch]),
        unsatisfied=torch.cat(unsats)[:batch],
    )


def ib_lut_decode_tiled(
    layout: DecodeLayout,
    trellis: DeviceTrellis,
    channel_clusters: torch.Tensor,
    batch_tile: int,
    max_iters: int | None = None,
    early_exit: bool = True,
) -> DecodeResult:
    """Plain twin of K1: :func:`ib_lut_decode` on each tile."""
    return decode_in_tiles(
        lambda ch: ib_lut_decode(
            layout, trellis, ch, max_iters=max_iters, early_exit=early_exit
        ),
        channel_clusters,
        batch_tile,
    )


def check_channel_input(
    x: torch.Tensor, dtype: torch.dtype, layout: DecodeLayout, what: str
) -> None:
    """Refuse a channel input the kernels do not take: they read ``dtype``
    [n_vars, batch]."""
    if x.dtype != dtype:
        raise TypeError(f"{what} must be {str(dtype).removeprefix('torch.')}")
    if x.dim() != 2 or x.shape[0] != layout.n_vars:
        raise ValueError(
            f"{what} must be [{layout.n_vars}, batch], got {tuple(x.shape)}"
        )


def layout_arrays(layout: DecodeLayout) -> dict[str, np.ndarray]:
    """The layout as the fused kernels take it (int32): the variable of each
    CN-view row and of each group-ordered VN, the routes between the views,
    the CN groups (offset, num_nodes, degree) and the VN groups (offset,
    num_nodes, degree, node offset)."""
    node_offsets = np.cumsum([0] + [g.num_nodes for g in layout.vn_groups])
    return dict(
        seed_var=layout.cn_edge_var,
        node_var=layout.vn_node_order,
        cn_route=layout.cn_to_vn_row,
        vn_route=layout.vn_to_cn_row,
        cn_groups=np.asarray(
            [(g.offset, g.num_nodes, g.degree) for g in layout.cn_groups], np.int32
        ),
        vn_groups=np.asarray(
            [
                (g.offset, g.num_nodes, g.degree, off)
                for g, off in zip(layout.vn_groups, node_offsets)
            ],
            np.int32,
        ),
    )


def device_arrays(arrays: dict[str, np.ndarray], device: torch.device) -> dict:
    """Contiguous tensors on ``device`` of host arrays."""
    return {
        k: torch.as_tensor(np.ascontiguousarray(v), device=device)
        for k, v in arrays.items()
    }


class FusedIBDecoder:
    """Tiled IB decoder: clusters [n_vars, batch] int32 -> DecodeResult.

    ``batch_tile`` codewords share one CTA and exit together; the default is
    the largest tile that fits shared memory. ``launches`` counts kernel
    launches (the CPU twin does not count).
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
        T, Tch = tables.cardinality_t_decoder, tables.cardinality_t_channel
        if Tch > T or T > 256:
            raise ValueError(
                f"the kernel takes |T_ch| <= |T| <= 256, got {Tch}, {T}"
            )
        if layout.d_c_max > tables.d_c_max or layout.d_v_max > tables.d_v_max:
            raise ValueError("code degrees exceed the tables' degrees")
        degrees = [g.degree for g in layout.cn_groups + layout.vn_groups]
        if max(degrees) > MAX_DEGREE or min(g.degree for g in layout.cn_groups) < 2:
            raise ValueError(
                f"the kernel takes node degrees up to {MAX_DEGREE} and check "
                "degrees of at least 2"
            )
        self.layout = layout
        self.tables = tables
        self.imax = max_iters if max_iters is not None else tables.i_max
        if self.imax > tables.i_max:
            raise ValueError("max_iters exceeds constructed i_max")
        self.early_exit = bool(early_exit)
        self.use_matching = bool(use_matching)
        if batch_tile is None:
            batch_tile = pick_batch_tile(layout, Tch, T)
        self.batch_tile = int(batch_tile)
        self.launches = 0
        self._trellis: dict[torch.device, DeviceTrellis] = {}
        self._kernel_args: dict[torch.device, dict] = {}

    def __call__(self, channel_clusters: torch.Tensor) -> DecodeResult:
        device = channel_clusters.device
        if device.type == "cpu":
            return ib_lut_decode_tiled(
                self.layout,
                self.trellis(device),
                channel_clusters,
                self.batch_tile,
                max_iters=self.imax,
                early_exit=self.early_exit,
            )
        if device.type != "cuda":
            raise ValueError(f"no kernel for device {device}")
        return self._launch(channel_clusters)

    def trellis(self, device: torch.device | str) -> DeviceTrellis:
        """The plain decoder's tables on ``device`` (cached)."""
        device = torch.device(device)
        if device not in self._trellis:
            self._trellis[device] = DeviceTrellis.from_tables(
                self.tables, device, use_matching=self.use_matching
            )
        return self._trellis[device]

    # -- kernel -----------------------------------------------------------
    def _host_tables(self) -> dict[str, np.ndarray]:
        """Tables laid out per DE iteration as uint8 slots of max(T,Tch)^2
        bytes, each holding one LUT row-major with its own column count as
        stride (Tch for the iteration-0 CN tables, T otherwise)."""
        t = self.tables
        T, Tch, i_max = t.cardinality_t_decoder, t.cardinality_t_channel, t.i_max
        slot = _slot(Tch, T)
        d_c, d_v = self.layout.d_c_max, self.layout.d_v_max
        n_cn_slots = max(d_c - 2, 1)
        cn = np.zeros((i_max, n_cn_slots, slot), np.uint8)
        vn = np.zeros((i_max, d_v, slot), np.uint8)

        def put(dst, lut):
            flat = np.asarray(lut).reshape(-1)
            dst[: flat.size] = flat

        put(cn[0, 0], t.cn_iter0_first)
        for l in range(d_c - 3):
            put(cn[0, l + 1], t.cn_iter0_rest[l])
        for k in range(1, i_max):
            for l in range(d_c - 2):
                put(cn[k, l], t.cn_rest[k - 1, l])
        for i in range(i_max):
            put(vn[i, 0], t.vn_first[i])
            for l in range(d_v - 1):
                put(vn[i, l + 1], t.vn_rest[i, l])
        if self.use_matching and t.has_matching:
            match_cn = np.asarray(t.matching_cn)[:, :d_c]
            match_vn = np.asarray(t.matching_vn)[:, :d_v]
        else:  # identity rows: no alignment
            ident = np.arange(T)
            match_cn = np.broadcast_to(ident, (i_max, d_c, T))
            match_vn = np.broadcast_to(ident, (i_max, d_v, T))
        return dict(
            cn_tab=cn,
            vn_tab=vn,
            match_cn=np.ascontiguousarray(match_cn, dtype=np.uint8),
            match_vn=np.ascontiguousarray(match_vn, dtype=np.uint8),
        )

    def host_arrays(self) -> dict[str, np.ndarray]:
        """The kernels' arguments as host arrays: :meth:`_host_tables`, the
        layout, and for K1 the routes as uint16 where the layout has at most
        65536 edges."""
        arrays = {**self._host_tables(), **layout_arrays(self.layout)}
        if self.layout.n_edges <= 65536:
            arrays["cn_route16"] = arrays["cn_route"].astype(np.uint16)
            arrays["vn_route16"] = arrays["vn_route"].astype(np.uint16)
        return arrays

    def _args(self, device: torch.device) -> dict:
        if device not in self._kernel_args:
            self._kernel_args[device] = device_arrays(self.host_arrays(), device)
        return self._kernel_args[device]

    def _launch(self, channel_clusters: torch.Tensor) -> DecodeResult:
        lay = self.layout
        check_channel_input(channel_clusters, torch.int32, lay, "channel clusters")
        bt = self.batch_tile
        v = columns_per_thread(bt)
        if bt // v > THREADS[v]:
            raise ValueError(
                f"K1 takes tiles of at most {THREADS[v] * v} codewords at {v} per thread"
            )
        device = channel_clusters.device
        ch = channel_clusters.contiguous()
        batch = ch.shape[1]
        a = self._args(device)
        out = torch.empty((lay.n_vars, batch), dtype=torch.int32, device=device)
        unsat = torch.empty(batch, dtype=torch.int32, device=device)
        iters = torch.empty(batch, dtype=torch.int32, device=device)
        t = self.tables
        route16 = [a[k].data_ptr() if k in a else None for k in ("cn_route16", "vn_route16")]
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            _library().decode(
                ch.data_ptr(), out.data_ptr(), unsat.data_ptr(), iters.data_ptr(),
                a["cn_tab"].data_ptr(), a["vn_tab"].data_ptr(),
                a["match_cn"].data_ptr(), a["match_vn"].data_ptr(),
                a["seed_var"].data_ptr(), a["node_var"].data_ptr(),
                a["cn_route"].data_ptr(), a["vn_route"].data_ptr(), *route16,
                a["cn_groups"].data_ptr(), a["vn_groups"].data_ptr(),
                len(lay.cn_groups), len(lay.vn_groups), lay.n_vars, lay.n_edges,
                batch, bt,
                t.cardinality_t_channel, t.cardinality_t_decoder,
                max(lay.d_c_max - 2, 1), lay.d_v_max,
                _slot(t.cardinality_t_channel, t.cardinality_t_decoder),
                lay.d_c_max, lay.d_v_max, self.imax, int(self.early_exit),
                stream,
            )
        self.launches += 1
        return DecodeResult(
            outputs=out,
            iterations=mean_iterations(iters),
            unsatisfied=unsat,
        )


def make_fused_ib_decoder(layout: DecodeLayout, tables: TrellisTables, **kw) -> FusedIBDecoder:
    """The :class:`FusedIBDecoder` of ``layout`` and ``tables`` (keywords as
    its constructor's)."""
    return FusedIBDecoder(layout, tables, **kw)


@functools.cache
def _library():
    """K1's library, built at first use."""
    from ._build import KernelLibrary

    p, i = ctypes.c_void_p, ctypes.c_int
    return KernelLibrary(
        "ib_lut_fused", [p] * 16 + [i] * 15 + [p], MAX_DEGREE,
        threads_v4=THREADS[4], threads_v1=THREADS[1],
    )
