"""Fused IB lookup-table decoder: the Hopper kernel K1 and its plain twin.

Port of ``kernels/ib_lut_fused.py`` (``FusedIBDecoder``). For a CUDA tensor
the decoder launches the hand-written kernel ``csrc/ib_lut_fused.cu`` (one
CTA per tile of ``batch_tile`` codewords, both message views in shared
memory, early exit per tile; where the tables take 4 bits a message, the
views at 4 bits and the pairwise tables of the passes copied per lane
(:func:`lane_words`), else the views as bytes, one table copy per block and
the routes in shared memory as uint16 where they fit,
:func:`kernel_shared_bytes`; each pass walked flat over its degree groups by
threads of :func:`columns_per_thread` codeword columns; on the per-lane path,
where a launch has too few tiles to fill the card, a tile on a thread-block
cluster of :func:`cluster_size` CTAs, each walking its share of the nodes,
:func:`cluster_arrays`);
for a CPU tensor it runs the plain twin
:func:`ib_lut_decode_tiled`, which applies the whole-batch decoder to each
zero-padded tile. The two agree bit for bit: outputs, per-codeword
unsatisfied counts and the mean iteration count. No CUDA tensor ever reaches
the twin, and a failed build or launch raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple

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
# The per-lane tables (kLane* in csrc/ib_lut_fused.cu): 16 byte positions in
# 4 groups of 256 entries x 32 lanes x 4 bytes, for |T| and |T_ch| at most 16.
LANE_POSITIONS = 16
LANE_ENTRIES = 256
LANE_BYTES = LANE_POSITIONS // 4 * LANE_ENTRIES * 128
LANE_MAX_T = 16
# The per-lane path's thread-block clusters: the CTAs a tile may take besides
# one, largest first (at most kMaxCluster in csrc/ib_lut_fused.cu).
CLUSTER_SIZES = (4, 3, 2)


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


class K1Carve(NamedTuple):
    """K1's shared memory a CTA, whether its routes are in it (else read from
    device memory), and whether the tile runs on per-lane tables."""

    bytes: int
    shared_routes: bool
    lanes: bool


def _ceil16(n: int) -> int:
    return -(-n // 16) * 16


def lane_groups(layout: DecodeLayout) -> tuple[int, int]:
    """The per-lane tables' groups that a CN stage writes (from the first)
    and the first group a VN stage writes (to the last): the CN pass's
    slot s at byte position s, the VN pass's (slots 0 .. d_v - 2) at
    15 - s."""
    cn_slots = max(layout.d_c_max - 2, 1)
    return -(-cn_slots // 4), (LANE_POSITIONS - (layout.d_v_max - 1)) // 4


def lane_stage_bytes(layout: DecodeLayout, t_decoder: int) -> tuple[int, int]:
    """Bytes of a CN and of a VN stage as :func:`lane_words` lays them out:
    the groups' words, then the alignment rows padded to 16 bytes."""
    cn_groups, vn_group0 = lane_groups(layout)
    words = 4 * LANE_ENTRIES
    return (
        cn_groups * words + _ceil16(layout.d_c_max * t_decoder),
        (LANE_POSITIONS // 4 - vn_group0) * words + _ceil16(layout.d_v_max * t_decoder),
    )


def lanes_fit(layout: DecodeLayout, t_channel: int, t_decoder: int) -> bool:
    """Whether the tables take per-lane copies (``lane_words``): |T| and
    |T_ch| at most 16 (4-bit messages, entries below 256), the CN pass's
    LUTs and the VN pass's (d_v - 1) within the 16 byte positions, and at
    most 65536 edges (uint16 routes)."""
    return (
        max(t_channel, t_decoder) <= LANE_MAX_T
        and max(layout.d_c_max - 2, 1) + layout.d_v_max - 1 <= LANE_POSITIONS
        and layout.d_v_max * _slot(t_channel, t_decoder) <= LANE_BYTES
        and layout.n_edges <= 65536
    )


def kernel_shared_bytes(
    layout: DecodeLayout, batch_tile: int, t_channel: int, t_decoder: int
) -> K1Carve:
    """K1's own carve, as ``shared_bytes`` in the .cu file. Where the tables
    take per-lane copies (:func:`lanes_fit`), the tile is a multiple of 4
    and it fits :data:`MAX_SHARED_BYTES`: the unsat counts, the views and
    the channel at 4 bits a message and the alignment rows (16-byte
    aligned), then the per-lane tables (:data:`LANE_BYTES`) and two buffers
    of the larger stage (:func:`lane_stage_bytes`); the routes are read from
    device memory. Else the tile rule's :func:`shared_bytes`, then
    the routes as uint16 (2-byte aligned) where they fit and the layout has
    at most 65536 edges. The tile rule (:func:`pick_batch_tile`) does not
    follow it."""
    if lanes_fit(layout, t_channel, t_decoder) and batch_tile % 4 == 0:
        views = (2 * layout.n_edges + layout.n_vars) * batch_tile // 2
        rows = (layout.d_c_max + layout.d_v_max) * t_decoder
        stages = max(lane_stage_bytes(layout, t_decoder))
        lane = _ceil16(2 * 4 * batch_tile + views + rows) + LANE_BYTES + 2 * stages
        if lane <= MAX_SHARED_BYTES:
            return K1Carve(lane, False, True)
    carve = shared_bytes(layout, batch_tile, t_channel, t_decoder)
    routes = -(-carve // 2) * 2 + 4 * layout.n_edges
    if layout.n_edges <= 65536 and routes <= MAX_SHARED_BYTES:
        return K1Carve(routes, True, False)
    return K1Carve(carve, False, False)


def cluster_size(tiles: int, active: dict[int, int]) -> int:
    """CTAs a tile of a per-lane launch runs on: the largest c of
    :data:`CLUSTER_SIZES` at which the launch's ``tiles``, a cluster of c
    CTAs each, do not exceed the clusters the card holds at once
    (``active[c]``, ``cudaOccupancyMaxActiveClusters`` at K1's carve), so
    that every tile runs in the first wave; else 1, a CTA a tile."""
    return next((c for c in CLUSTER_SIZES if tiles <= active.get(c, 0)), 1)


def node_lookups(layout: DecodeLayout, kind: str) -> np.ndarray:
    """Lookups of each node of the CN ('cn') or VN ('vn') pass in K1's flat
    walk order, with alignment (``utils/roofline.py``
    ``ib_lookup_counts``): a check of degree d (d-2)(d+3)/2 pairwise and d
    alignment lookups, a variable (d-1)(d+2)/2 and d; a degree-1 variable
    counts 1, its forwarded channel's store."""
    if kind == "cn":
        cost = [(g.degree - 2) * (g.degree + 3) // 2 + g.degree for g in layout.cn_groups]
        groups = layout.cn_groups
    else:
        cost = [(g.degree - 1) * (g.degree + 2) // 2 + g.degree for g in layout.vn_groups]
        groups = layout.vn_groups
    return np.repeat(np.asarray(cost, np.int64), [g.num_nodes for g in groups])


def cluster_split(layout: DecodeLayout, cluster: int) -> np.ndarray:
    """[2, cluster + 1] int32: rank r of a cluster walks the checks
    split[0, r] .. split[0, r + 1] - 1 and the variables split[1, r] ..
    split[1, r + 1] - 1, in K1's flat walk order. Each pass's shares are
    contiguous and balanced by lookups (:func:`node_lookups`): boundary r is
    the node boundary nearest to r / cluster of the pass's lookups."""
    split = np.zeros((2, cluster + 1), np.int32)
    for k, kind in enumerate(("cn", "vn")):
        cum = np.concatenate([[0], np.cumsum(node_lookups(layout, kind))])
        for r in range(1, cluster):
            target = cum[-1] * r / cluster
            i = int(np.searchsorted(cum, target))
            if target - cum[i - 1] <= cum[i] - target:
                i -= 1
            split[k, r] = max(i, split[k, r - 1])
        split[k, cluster] = len(cum) - 1
    return split


def _row_nodes(groups) -> np.ndarray:
    """The node (flat walk index) of each view row: a group's row
    offset + k * num_nodes + ln belongs to its node ln."""
    rows = np.zeros(sum(g.num_nodes * g.degree for g in groups), np.int64)
    first = 0
    for g in groups:
        rows[g.offset : g.offset + g.degree * g.num_nodes] = np.tile(
            first + np.arange(g.num_nodes), g.degree)
        first += g.num_nodes
    return rows


def cluster_arrays(layout: DecodeLayout, cluster: int) -> dict[str, np.ndarray]:
    """K1's arguments on clusters of ``cluster`` CTAs: ``split``
    (:func:`cluster_split`) and the routes as uint32, the row in the low 16
    bits and above them the rank that walks the row's node, which holds the
    row: a CN-view row's route names a VN-view row, whose variable's rank
    holds it, and a VN-view row's a CN-view row of a check."""
    split = cluster_split(layout, cluster)
    arrays = layout_arrays(layout)
    owner = {}
    for k, (kind, groups) in enumerate((("cn", layout.cn_groups), ("vn", layout.vn_groups))):
        rank = np.searchsorted(split[k], np.arange(split[k, -1]), side="right") - 1
        owner[kind] = rank[_row_nodes(groups)]
    cn_route = arrays["cn_route"].astype(np.int64)  # to VN-view rows
    vn_route = arrays["vn_route"].astype(np.int64)  # to CN-view rows
    return dict(
        split=split.reshape(-1),
        cn_route_cl=(cn_route | owner["vn"][cn_route] << 16).astype(np.uint32),
        vn_route_cl=(vn_route | owner["cn"][vn_route] << 16).astype(np.uint32),
    )


def pick_batch_tile(
    layout: DecodeLayout, t_channel: int, t_decoder: int
) -> int:
    """Largest tile of 32/16/8/4/2/1 codewords whose CTA fits 227 KB with
    byte views and one table copy (:func:`shared_bytes`), whether or not it
    then runs on per-lane tables: the tile, so the exit granularity, does
    not depend on the path."""
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


def lane_words(
    tables: dict[str, np.ndarray], layout: DecodeLayout
) -> tuple[np.ndarray, np.ndarray]:
    """The per-lane tables' stages, as K1 copies them into shared memory
    ([i_max, stage bytes / 4] uint32 each, :func:`lane_stage_bytes`): a
    stage's groups of words, each word the four byte positions 4 g .. 4 g + 3
    of one entry x (word x of its group), then the stage's alignment rows
    (``match_cn`` or ``match_vn`` of :meth:`FusedIBDecoder._host_tables`),
    padded to 16 bytes. The CN pass's slot s sits at position s, the VN
    pass's (slots 0 .. d_v - 2) at 15 - s. A CN stage of iteration k writes
    the groups of the CN positions with the CN tables of k, and in a group
    shared with the VN positions the VN tables of k - 1, which the VN pass
    running beside the stage reads; a VN stage of k the groups of the VN
    positions with the VN tables of k and the CN tables of k. So a stage
    rewrites the other pass's bytes unchanged."""
    cn_tab, vn_tab = tables["cn_tab"], tables["vn_tab"]
    i_max, c, slot = cn_tab.shape
    v = layout.d_v_max - 1
    cn = np.zeros((i_max, LANE_POSITIONS, LANE_ENTRIES), np.uint8)
    vn = np.zeros_like(cn)
    cn[:, :c, :slot] = cn_tab
    vn[:, LANE_POSITIONS - 1 - np.arange(v), :slot] = vn_tab[:, :v]
    vn_before = np.concatenate([np.zeros_like(vn[:1]), vn[:-1]])
    cn_groups, vn_group0 = lane_groups(layout)

    def stage(pos: np.ndarray, rows: np.ndarray) -> np.ndarray:
        i, q, e = pos.shape
        words = np.ascontiguousarray(pos.reshape(i, q // 4, 4, e).transpose(0, 1, 3, 2))
        flat_rows = rows.reshape(i, -1)
        padded = np.zeros((i, _ceil16(flat_rows.shape[1])), np.uint8)
        padded[:, : flat_rows.shape[1]] = flat_rows
        return np.concatenate([words.reshape(i, -1), padded], axis=1).view("<u4")

    return (
        stage((cn | vn_before)[:, : 4 * cn_groups], tables["match_cn"]),
        stage((vn | cn)[:, 4 * vn_group0 :], tables["match_vn"]),
    )


def device_arrays(arrays: dict[str, np.ndarray], device: torch.device) -> dict:
    """Contiguous tensors on ``device`` of host arrays."""
    return {
        k: torch.as_tensor(np.ascontiguousarray(v), device=device)
        for k, v in arrays.items()
    }


class FusedIBDecoder:
    """Tiled IB decoder: clusters [n_vars, batch] int32 -> DecodeResult.

    ``batch_tile`` codewords share one CTA, or on the per-lane path one
    thread-block cluster of CTAs, and exit together; the default is the
    largest tile that fits shared memory. ``launches`` counts kernel
    launches (the CPU twin does not count), ``cluster_launches`` those on
    clusters, and ``cluster`` is the CTAs a tile of the last launch took.
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
        self.cluster_launches = 0
        self.cluster = 1
        self._trellis: dict[torch.device, DeviceTrellis] = {}
        self._kernel_args: dict[torch.device, dict] = {}
        self._clusters: dict[tuple[torch.device, int], int] = {}
        self._cluster_args: dict[tuple[torch.device, int], dict] = {}

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
        65536 edges and the per-lane tables' words where the tile runs on
        them (:func:`kernel_shared_bytes`, :func:`lane_words`)."""
        arrays = {**self._host_tables(), **layout_arrays(self.layout)}
        if self.layout.n_edges <= 65536:
            arrays["cn_route16"] = arrays["cn_route"].astype(np.uint16)
            arrays["vn_route16"] = arrays["vn_route"].astype(np.uint16)
        t = self.tables
        if kernel_shared_bytes(
            self.layout, self.batch_tile, t.cardinality_t_channel, t.cardinality_t_decoder
        ).lanes:
            arrays["lane_cn"], arrays["lane_vn"] = lane_words(arrays, self.layout)
        return arrays

    def _args(self, device: torch.device) -> dict:
        if device not in self._kernel_args:
            self._kernel_args[device] = device_arrays(self.host_arrays(), device)
        return self._kernel_args[device]

    def _cluster_for(self, device: torch.device, batch: int) -> int:
        """The CTAs a tile takes at ``batch``: :func:`cluster_size` on the
        per-lane path, with the card's counts queried once per device and
        carve; else 1. Cached per device and batch."""
        key = (device, batch)
        if key not in self._clusters:
            t, lay, bt = self.tables, self.layout, self.batch_tile
            tch, tdec = t.cardinality_t_channel, t.cardinality_t_decoder
            c = 1
            if kernel_shared_bytes(lay, bt, tch, tdec).lanes:
                active = _max_active_clusters(device.index, lay.n_vars, lay.n_edges, bt, tch,
                                              tdec, lay.d_c_max, lay.d_v_max)
                c = cluster_size(-(-batch // bt), active)
            self._clusters[key] = c
        return self._clusters[key]

    def _launch(self, channel_clusters: torch.Tensor, cluster: int | None = None) -> DecodeResult:
        """Launches K1; ``cluster`` overrides the CTAs a tile (1, or a size
        of :data:`CLUSTER_SIZES` where the tile runs on per-lane tables),
        which the launch otherwise chooses from the card
        (:meth:`_cluster_for`)."""
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
        c = self._cluster_for(device, batch) if cluster is None else cluster
        cl = {}
        if c > 1:
            if (device, c) not in self._cluster_args:
                self._cluster_args[device, c] = device_arrays(cluster_arrays(lay, c), device)
            cl = self._cluster_args[device, c]
        out = torch.empty((lay.n_vars, batch), dtype=torch.int32, device=device)
        unsat = torch.empty(batch, dtype=torch.int32, device=device)
        iters = torch.empty(batch, dtype=torch.int32, device=device)
        t = self.tables
        optional = [
            a[k].data_ptr() if k in a else None
            for k in ("cn_route16", "vn_route16", "lane_cn", "lane_vn")
        ] + [cl[k].data_ptr() if cl else None for k in ("cn_route_cl", "vn_route_cl", "split")]
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            _library().decode(
                ch.data_ptr(), out.data_ptr(), unsat.data_ptr(), iters.data_ptr(),
                a["cn_tab"].data_ptr(), a["vn_tab"].data_ptr(),
                a["match_cn"].data_ptr(), a["match_vn"].data_ptr(),
                a["seed_var"].data_ptr(), a["node_var"].data_ptr(),
                a["cn_route"].data_ptr(), a["vn_route"].data_ptr(), *optional,
                a["cn_groups"].data_ptr(), a["vn_groups"].data_ptr(),
                len(lay.cn_groups), len(lay.vn_groups), lay.n_vars, lay.n_edges,
                batch, bt,
                t.cardinality_t_channel, t.cardinality_t_decoder,
                max(lay.d_c_max - 2, 1), lay.d_v_max,
                _slot(t.cardinality_t_channel, t.cardinality_t_decoder),
                lay.d_c_max, lay.d_v_max, self.imax, int(self.early_exit), c,
                stream,
            )
        self.launches += 1
        self.cluster = c
        self.cluster_launches += int(c > 1)
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
def _max_active_clusters(device_index: int, n_vars: int, n_edges: int, batch_tile: int,
                         t_channel: int, t_decoder: int, d_c_max: int,
                         d_v_max: int) -> dict[int, int]:
    """The clusters of each size of :data:`CLUSTER_SIZES` that card
    ``device_index`` holds at once with K1's per-lane carve for this layout
    and tile (``ib_lut_fused_max_clusters``: cudaOccupancyMaxActiveClusters),
    queried once per device and carve."""
    lib = _library()
    # Non-null stand-ins: the query reads only whether the per-lane
    # arguments exist.
    some = ctypes.c_void_p(1)
    active = {}
    with torch.cuda.device(device_index):
        for c in CLUSTER_SIZES:
            n = ctypes.c_int()
            lib.launch(
                "ib_lut_fused_max_clusters", some, some, n_vars, n_edges, batch_tile,
                t_channel, t_decoder, max(d_c_max - 2, 1), d_v_max,
                _slot(t_channel, t_decoder), d_c_max, d_v_max, c, ctypes.byref(n),
            )
            active[c] = n.value
    return active


@functools.cache
def _library():
    """K1's library, built at first use."""
    from ._build import KernelLibrary

    p, i = ctypes.c_void_p, ctypes.c_int
    return KernelLibrary(
        "ib_lut_fused", [p] * 21 + [i] * 16 + [p], MAX_DEGREE,
        functions={"ib_lut_fused_max_clusters": [p, p] + [i] * 11 + [ctypes.POINTER(i)]},
        threads_v4=THREADS[4], threads_v1=THREADS[1], lane_bytes=LANE_BYTES,
        max_cluster=max(CLUSTER_SIZES),
    )
