"""P6: the port's K3 pass program replayed with the folds replaced, and its
plain version.

Port of the Pallas probe ``scripts/stage_replay.py`` ``build``, which
replays the TPU K3's stage program on the DVB-S2 layout with fold and
scatter removed. The port's K3 (``csrc/ib_lut_hbm.cu``) has no DMA chassis,
so the replay is defined against the port's K3 as it runs instead, and keeps
what it does to memory: the ``ib_lut::Graph`` arrays (``layout_arrays``),
uint8 views ``[tile][row][128]`` in device memory, and per body a VN pass
(B -> A, also reading the channel plane ``chg``) and a CN pass (A -> B),
each as K3's wide passes (``csrc/hbm_wide.cuh``): 8 codeword columns a
thread, one 8-byte load per input row ``src[(off + k n + node) bt + c]`` and
one 8-byte store per routed output row ``dst[route[off + k n + node] bt +
c]``, nodes above the split degree in a second launch at 4 columns. In place
of the lookup-table folds, output message k of a node is the XOR of its
other inputs (the channel included) XOR k: a leave-one-out fold that costs
one operation per input. A degree-1 variable node forwards its channel
value, as in K3. None of this changes the function: the views after n
bodies do not depend on how threads are laid out.

Variants (:data:`VARIANTS`), each a :class:`ReplayProgram`:

- ``exact``: both passes as above;
- ``nochv``: the VN pass does not read ``chg`` (its value is 0);
- ``cn_only``, ``vn_only``: one pass per body;
- ``nosmall``: groups of at most 8 nodes skipped (``stage_replay.py:82-84``);
- ``nowrite``: reads only, summed per tile into wrapping int32 checksums;
- ``staged``: the counterpart of the script's ``depth4``: a group's plane k
  over nodes [n0, n0 + piece) is ``piece`` contiguous 128-byte rows of a
  tile's slab, bulk-copied with the channel rows into a shared-memory stage
  (two stages per block, one mbarrier each, as many blocks as the card holds
  at once), then consumed 8 columns a thread and written routed.

The script's ``outviews`` stages from a Pallas output aliased to its input;
the card has no such distinction, so it has no counterpart.

:class:`StageReplay` runs a variant's bodies on :class:`ReplayViews`: for
CUDA views it launches ``csrc/stage_replay.cu`` and counts the call in
:data:`launches`; for CPU views it runs :func:`replay_plain`, the same
passes by gather and ``index_put_``. Both change the views (or, for
``nowrite``, the checksums) in place and agree bit for bit. There is no
fallback from one to the other.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools

import numpy as np
import torch

from ..decode.graph_arrays import DecodeLayout
from .bulk_read import wrap_int32
from .ib_lut_fused import device_arrays, layout_arrays

BATCH_TILE = 128  # codewords per tile, K3's (kernels/ib_lut_hbm.py)
SMALL_GROUP = 8  # 'nosmall' skips groups of at most this many nodes
PIECE = 24  # nodes per staged unit: 9 planes of 24 rows are a 27 KB stage
VARIANTS = ("exact", "nochv", "cn_only", "vn_only", "nosmall", "nowrite", "staged")
TPU_VARIANT = {v: v for v in VARIANTS} | {"staged": "depth4"}  # the script's name
_MODE = {"write": 0, "nowrite": 1, "staged": 2}

# Kernel calls per variant, each running its bodies (the plain version does
# not count).
launches: collections.Counter = collections.Counter()


@dataclasses.dataclass(frozen=True)
class ReplayProgram:
    """The passes of one variant: the VN pass's groups (offset, num_nodes,
    degree, node offset) and the CN pass's (offset, num_nodes, degree), a
    pass with no group not run; whether the VN pass reads the channel plane,
    whether the passes write (else they sum what they read), and whether
    they stage their reads."""

    variant: str
    vn_groups: np.ndarray
    cn_groups: np.ndarray
    chv: bool
    write: bool
    staged: bool


def replay_program(layout: DecodeLayout, variant: str) -> ReplayProgram:
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; expected one of {VARIANTS}")
    arrays = layout_arrays(layout)
    vn, cn = arrays["vn_groups"], arrays["cn_groups"]
    if variant == "nosmall":
        vn, cn = vn[vn[:, 1] > SMALL_GROUP], cn[cn[:, 1] > SMALL_GROUP]
    elif variant == "cn_only":
        vn = vn[:0]
    elif variant == "vn_only":
        cn = cn[:0]
    return ReplayProgram(variant, vn, cn, chv=variant != "nochv", write=variant != "nowrite",
                         staged=variant == "staged")


def rows_read(program: ReplayProgram) -> dict[str, np.ndarray]:
    """The rows one body reads, in order, once each: of the VN view B
    (``vn``), of the channel plane (``chg``) and of the CN view A (``cn``).
    A degree-1 variable node reads no message."""
    vn = [off + np.arange(d * n) for off, n, d, _ in program.vn_groups if d > 1]
    chg = [node + np.arange(n) for _, n, _, node in program.vn_groups] if program.chv else []
    cn = [off + np.arange(d * n) for off, n, d in program.cn_groups]
    return {k: np.concatenate(v) if v else np.zeros(0, np.int64)
            for k, v in (("vn", vn), ("chg", chg), ("cn", cn))}


def bytes_per_body(program: ReplayProgram, batch: int) -> int:
    """Device-memory bytes one body moves at ``batch`` codewords: every row
    it reads and every row it writes (a pass writes one row per edge of its
    groups), one byte per codeword."""
    rows = sum(len(r) for r in rows_read(program).values())
    if program.write:
        rows += sum(int(d * n) for _, n, d, _ in program.vn_groups)
        rows += sum(int(d * n) for _, n, d in program.cn_groups)
    return rows * batch


@dataclasses.dataclass
class ReplayViews:
    """The state a replay changes: the CN view ``A`` and VN view ``B``
    (uint8 [n_tiles, n_edges, 128]), the channel plane ``chg`` (uint8
    [n_tiles, n_vars, 128]) and ``sums`` (int32 [n_tiles], the checksums
    of ``nowrite``)."""

    A: torch.Tensor
    B: torch.Tensor
    chg: torch.Tensor
    sums: torch.Tensor

    @classmethod
    def random(cls, layout: DecodeLayout, batch: int, device: torch.device | str, seed: int = 0):
        """Seeded views of ``batch`` codewords (a whole number of tiles)."""
        if batch % BATCH_TILE:
            raise ValueError(f"the replay takes whole tiles of {BATCH_TILE} codewords, got {batch}")
        g = torch.Generator(device=device)
        g.manual_seed(seed)
        tiles = batch // BATCH_TILE

        def draw(rows: int) -> torch.Tensor:
            return torch.randint(0, 256, (tiles, rows, BATCH_TILE), dtype=torch.uint8,
                                 device=device, generator=g)

        return cls(draw(layout.n_edges), draw(layout.n_edges), draw(layout.n_vars),
                   torch.zeros(tiles, dtype=torch.int32, device=device))

    def clone(self) -> "ReplayViews":
        return ReplayViews(*(x.clone() for x in (self.A, self.B, self.chg, self.sums)))

    def equal(self, other: "ReplayViews") -> bool:
        return all(torch.equal(x, y) for x, y in zip(
            (self.A, self.B, self.chg, self.sums), (other.A, other.B, other.chg, other.sums)))


def _xor_fold(messages: torch.Tensor, first: torch.Tensor) -> torch.Tensor:
    """Leave-one-out outputs of [tiles, d, n, bt] messages: message k's
    output is ``first`` XOR every other message XOR k."""
    total = first.clone()
    for k in range(messages.shape[1]):
        total ^= messages[:, k]
    k = torch.arange(messages.shape[1], dtype=torch.uint8, device=messages.device)
    return total[:, None] ^ messages ^ k[None, :, None, None]


def _add_sums(sums: torch.Tensor, rows: torch.Tensor) -> None:
    """Add the bytes of ``rows`` [tiles, r, bt] to ``sums`` (int32, modulo
    2^32 per tile)."""
    sums.copy_(wrap_int32(sums.to(torch.int64) + rows.sum((1, 2), dtype=torch.int64)))


def vn_pass_plain(program, src, dst, chg, route, sums) -> None:
    """One VN pass, ``src`` (B) -> ``dst`` (A)."""
    for off, n, d, node in program.vn_groups.tolist():
        messages = src[:, off:off + d * n] if d > 1 else src[:, :0]  # degree 1 reads none
        ch = chg[:, node:node + n] if program.chv else torch.zeros_like(chg[:, :n])
        if not program.write:
            _add_sums(sums, messages)
            if program.chv:
                _add_sums(sums, ch)
            continue
        out = ch[:, None] if d == 1 else _xor_fold(messages.unflatten(1, (d, n)), ch)
        dst[:, route[off:off + d * n]] = out.flatten(1, 2)


def cn_pass_plain(program, src, dst, route, sums) -> None:
    """One CN pass, ``src`` (A) -> ``dst`` (B)."""
    for off, n, d in program.cn_groups.tolist():
        if not program.write:
            _add_sums(sums, src[:, off:off + d * n])
            continue
        m = src[:, off:off + d * n].unflatten(1, (d, n))
        dst[:, route[off:off + d * n]] = _xor_fold(m, torch.zeros_like(m[:, 0])).flatten(1, 2)


def replay_plain(program: ReplayProgram, views: ReplayViews, routes: dict, bodies: int = 1) -> None:
    """``bodies`` bodies of ``program`` on ``views``, in place; ``routes``
    holds ``cn_route`` and ``vn_route`` (int64 tensors on the views'
    device)."""
    for _ in range(bodies):
        if len(program.vn_groups):
            vn_pass_plain(program, views.B, views.A, views.chg, routes["vn_route"], views.sums)
        if len(program.cn_groups):
            cn_pass_plain(program, views.A, views.B, routes["cn_route"], views.sums)


def max_degree(groups: np.ndarray) -> int:
    """The largest degree of a pass's groups (0 for none): the kernel makes
    its second launch when it is above ``csrc/hbm_wide.cuh``'s split degree."""
    return int(groups[:, 2].max()) if len(groups) else 0


def staged_units(groups: np.ndarray, piece: int = PIECE) -> np.ndarray:
    """The staged units of a pass: int32 [units, 2], (group index, first
    node), ``piece`` nodes each (fewer at a group's end)."""
    units = [(gi, n0) for gi, n in enumerate(groups[:, 1].tolist()) for n0 in range(0, n, piece)]
    return np.asarray(units, np.int32).reshape(-1, 2)


class StageReplay:
    """One variant of the replay on ``layout``."""

    def __init__(self, layout: DecodeLayout, variant: str):
        self.layout = layout
        self.program = replay_program(layout, variant)
        arrays = layout_arrays(layout)
        self._host = {
            "cn_route": arrays["cn_route"], "vn_route": arrays["vn_route"],
            "cn_groups": self.program.cn_groups, "vn_groups": self.program.vn_groups,
            "cn_units": staged_units(self.program.cn_groups),
            "vn_units": staged_units(self.program.vn_groups),
        }
        # Planes of one staged unit: a group's messages, then its channel rows.
        chv = int(self.program.chv)
        self.stage_planes = max(
            [d + chv if d > 1 else chv for d in self.program.vn_groups[:, 2].tolist()]
            + self.program.cn_groups[:, 2].tolist() + [1]
        )
        self._device: dict = {}

    @property
    def name(self) -> str:
        return self.program.variant

    def bytes_per_body(self, batch: int) -> int:
        return bytes_per_body(self.program, batch)

    def _arrays(self, device: torch.device) -> dict:
        key = str(device)
        if key not in self._device:
            self._device[key] = device_arrays(self._host, device)
        return self._device[key]

    def plain(self, views: ReplayViews, bodies: int = 1) -> None:
        a = self._arrays(views.A.device)
        routes = {k: a[k].long() for k in ("cn_route", "vn_route")}
        replay_plain(self.program, views, routes, bodies)

    def __call__(self, views: ReplayViews, bodies: int = 1) -> None:
        """Run ``bodies`` bodies on ``views`` in place."""
        lay = self.layout
        tiles = views.A.shape[0]
        want = {"A": (tiles, lay.n_edges, BATCH_TILE), "B": (tiles, lay.n_edges, BATCH_TILE),
                "chg": (tiles, lay.n_vars, BATCH_TILE)}
        for name, shape in want.items():
            x = getattr(views, name)
            if x.dtype != torch.uint8 or tuple(x.shape) != shape:
                raise ValueError(f"{name} must be uint8 {list(shape)}, got {x.dtype} {tuple(x.shape)}")
        if views.sums.dtype != torch.int32 or tuple(views.sums.shape) != (tiles,):
            raise ValueError(f"sums must be int32 [{tiles}]")
        if views.A.device.type == "cpu":
            self.plain(views, bodies)
            return
        if not all(x.is_contiguous() for x in (views.A, views.B, views.chg, views.sums)):
            raise ValueError("the views must be contiguous")
        device = views.A.device
        a = self._arrays(device)
        p = self.program
        mode = _MODE["staged" if p.staged else "write" if p.write else "nowrite"]
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            _library().launch(
                "stage_replay", mode, int(p.chv),
                views.A.data_ptr(), views.B.data_ptr(), views.chg.data_ptr(), views.sums.data_ptr(),
                a["cn_groups"].data_ptr(), a["vn_groups"].data_ptr(),
                a["cn_route"].data_ptr(), a["vn_route"].data_ptr(),
                len(p.cn_groups), len(p.vn_groups),
                a["cn_units"].data_ptr(), len(self._host["cn_units"]),
                a["vn_units"].data_ptr(), len(self._host["vn_units"]),
                self.stage_planes, max_degree(p.cn_groups), max_degree(p.vn_groups),
                lay.n_vars, lay.n_checks, lay.n_edges, tiles, bodies, stream,
            )
        launches[self.name] += 1


@functools.cache
def _library():
    """P6's library, built at first use."""
    from ._build import CLibrary

    p, i = ctypes.c_void_p, ctypes.c_int
    lib = CLibrary("stage_replay", {
        "stage_replay": [i, i] + [p] * 8 + [i, i, p, i, p, i] + [i] * 8 + [p],
        "stage_replay_batch_tile": [],
        "stage_replay_piece": [],
    })
    if (lib.value("stage_replay_batch_tile"), lib.value("stage_replay_piece")) != (BATCH_TILE, PIECE):
        raise RuntimeError("csrc/stage_replay.cu and kernels/stage_replay.py disagree on the tile or piece")
    return lib
