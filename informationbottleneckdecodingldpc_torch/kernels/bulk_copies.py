"""P4: waves of bulk copies at table-driven offsets, scatter and stage, and
their plain versions.

Port of the Pallas probe ``scripts/dma_probe.py`` (``build``: waves of 512
dynamic DMAs of L rows, scatter VMEM -> HBM or stage HBM -> VMEM;
``build_tiny_loops``: the same waves waited for a few entries at a time).
Rows are the TPU's 512 bytes. :func:`copy_tables` makes the tables as
``dma_probe.py:38-44`` makes them: copy k of a wave goes to device-memory
row ``perm[k] * G`` (G = max(L, 8 rows), a seeded permutation of the
target's slots) and to shared-memory row ``(k mod (region / G)) * G`` of a
192 KB region. With more than one region, region r gets a target range of
its own of ``wave * G`` rows and a permutation of its slots.

``csrc/bulk_copies.cu`` runs them on the card. The TPU probe issued a wave
from the chip's one TensorCore; here a launch's copies (:func:`flat_tables`:
every region's wave, interleaved) are dealt over ``blocks`` blocks, copy k to
block k mod blocks, and inside a block over :data:`WARPS` issuing warps
(:func:`issue_groups`); a copy lands in the region slot of its position in
its block's share. The card-wide wave deals one region's 512 copies over
one block per SM, ``x1`` runs that wave on one block (one SM's issue
cost), ``x132`` gives each of 132 blocks a wave of its own. ``scatter``
copies shared image rows (loaded from ``image`` at the start) to the
target, one bulk group and wait per ``entries`` copies of a warp; ``stage``
copies from the source into a block's region, a warp owning the slots
congruent to it modulo :data:`WARPS`, one mbarrier phase per group of at most
:func:`group_size` copies that ends before a second copy into one slot, and
returns the wrapping int32 sum of each block's region afterwards.
:class:`BulkCopies` launches the kernel for CUDA tensors and counts the
launch in :data:`launches`; for CPU tensors it runs the plain versions
(:func:`scatter_plain`, an ``index_copy_`` of the rows :func:`scatter_rows`
lists, and :func:`stage_plain`). There is no fallback from one to the other.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import numpy as np
import torch

from .bulk_read import ROW_BYTES, wrap_int32

WAVE = 512  # copies per wave
TARGET_ROWS = 1 << 20  # 512 MB: one region's target, the TPU probe's
REGION_ROWS = 384  # 192 KB of shared memory
MIN_SPACING_ROWS = 8  # 4 KB between two copies' slots
MAX_TX_BYTES = (1 << 20) - 1  # an mbarrier phase's transaction count
WARPS = 8  # issuing warps per block: csrc/bulk_copies.cu's kThreads / 32
DIRECTIONS = ("scatter", "stage")
_DIRECTION = {"scatter": 0, "stage": 1}

# Kernel launches per variant name (``BulkCopies.name``); the plain versions
# do not count.
launches: collections.Counter = collections.Counter()


def spacing(copy_rows: int) -> int:
    return max(copy_rows, MIN_SPACING_ROWS)


def copy_tables(
    copy_rows: int, blocks: int = 1, wave: int = WAVE, target_rows: int = TARGET_ROWS,
    region_rows: int = REGION_ROWS,
) -> tuple[np.ndarray, np.ndarray]:
    """int32 device-memory rows [blocks, wave] and shared-memory rows [wave]
    of one wave per target region (``blocks`` regions), from numpy's
    generator seeded 0 as the TPU probe's. One region draws
    ``rng.permutation(slots)`` over ``target_rows``; region b of several
    draws a permutation of its own ``wave`` slots, starting at row
    ``b * wave * G``."""
    g = spacing(copy_rows)
    rng = np.random.default_rng(0)
    slots = target_rows // g if blocks == 1 else wave
    dst = np.stack([b * slots * g + rng.permutation(slots)[:wave] * g for b in range(blocks)])
    smem = (np.arange(wave) % (region_rows // g)) * g
    return dst.astype(np.int32), smem.astype(np.int32)


def flat_tables(dst: np.ndarray, smem: np.ndarray, blocks: int) -> tuple[np.ndarray, np.ndarray]:
    """The copies of one launch's wave dealt over ``blocks`` blocks, int32
    [regions x wave] each: copy i x regions + r is region r's copy i, so
    that dealt over ``regions`` blocks, block r takes its region's wave in
    order; a copy lands in the slot of its position in its block's share,
    ``smem[k // blocks]``, as one block's copy k lands in ``smem[k]``."""
    regions, wave = dst.shape
    if -(-regions * wave // blocks) > len(smem):
        raise ValueError(f"{regions} waves on {blocks} blocks give a block more copies than the table")
    copy_dst = np.ascontiguousarray(dst.T).reshape(-1)
    return copy_dst, smem[np.arange(len(copy_dst)) // blocks].astype(np.int32)


def share_slots(smem: np.ndarray, copy_rows: int, share: int) -> int:
    """The region slots (one bit each) that the first ``share`` positions of
    a block's share read: the image slots a scatter block loads."""
    bits = np.left_shift(np.uint64(1), (smem[:share] // spacing(copy_rows)).astype(np.uint64))
    return int(np.bitwise_or.reduce(bits, initial=np.uint64(0)))


def group_size(direction: str, copy_rows: int, entries: int, wave: int = WAVE,
               region_rows: int = REGION_ROWS) -> int:
    """Copies per wait: ``entries`` for a scatter; for a stage also at most
    the region's slots and what one mbarrier phase can count."""
    group = min(entries, wave)
    if direction == "stage":
        group = min(group, region_rows // spacing(copy_rows), MAX_TX_BYTES // (copy_rows * ROW_BYTES))
    return group


def issue_groups(direction: str, smem: np.ndarray, copy_rows: int, group: int, blocks: int,
                 warps: int = WARPS) -> dict[tuple[int, int], list[list[int]]]:
    """The copies of a wave (indices into the flat tables, whose region rows
    are ``smem``) each (block, warp) issues, in its groups of one wait each,
    as ``csrc/bulk_copies.cu`` issues them. Block b's share is copies b,
    b + blocks, ...; a scatter gives share position i to warp i mod
    ``warps`` and cuts its copies into groups of ``group``; a stage gives a
    copy to the warp that owns its slot (slot mod ``warps``) and ends a
    group at ``group`` copies or before a second copy into one slot."""
    g = spacing(copy_rows)
    out: dict[tuple[int, int], list[list[int]]] = {}
    for b in range(min(blocks, len(smem))):
        share = list(range(b, len(smem), blocks))
        for w in range(warps):
            if direction == "scatter":
                mine = share[w::warps]
                groups = [mine[i:i + group] for i in range(0, len(mine), group)]
            else:
                groups, open_ = [], set()
                for k in (k for k in share if smem[k] // g % warps == w):
                    slot = smem[k] // g
                    if not groups or len(groups[-1]) == group or slot in open_:
                        groups.append([])
                        open_ = set()
                    groups[-1].append(k)
                    open_.add(slot)
            if groups:
                out[b, w] = groups
    return out


def scatter_rows(dst: np.ndarray, smem: np.ndarray, copy_rows: int) -> tuple[np.ndarray, np.ndarray]:
    """Target rows and image rows of the copies of the flat tables ``dst``
    and ``smem``, in copy order (int64)."""
    span = np.arange(copy_rows)
    to = (dst[:, None].astype(np.int64) + span).reshape(-1)
    frm = (smem[:, None].astype(np.int64) + span).reshape(-1)
    return to, frm


def scatter_plain(image: torch.Tensor, target: torch.Tensor, dst: np.ndarray, smem: np.ndarray,
                  copy_rows: int) -> torch.Tensor:
    """Every copy of the flat tables from ``image`` rows into ``target``
    ([rows, 128] int32), by one ``index_copy_``: no two copies of a wave
    share a target row, so how they are dealt does not matter."""
    to, frm = (torch.as_tensor(a, device=target.device) for a in scatter_rows(dst, smem, copy_rows))
    return target.index_copy_(0, to, image.index_select(0, frm))


def stage_rows(dst: np.ndarray, smem: np.ndarray, copy_rows: int, blocks: int) -> tuple[np.ndarray, np.ndarray]:
    """The copies that a block's region holds after a wave of the flat
    tables dealt over ``blocks`` blocks: in each block's share the last copy
    into each slot (all copies into a slot are one warp's, issued in order).
    Returns their source rows [copies, copy_rows] (int64) and blocks."""
    key = (np.arange(len(dst)) % blocks) * (int(smem.max()) + 1) + smem
    _, first_of_reversed = np.unique(key[::-1], return_index=True)
    last = np.sort(len(key) - 1 - first_of_reversed)
    return dst[last][:, None].astype(np.int64) + np.arange(copy_rows), last % blocks


def stage_plain(source: torch.Tensor, dst: np.ndarray, smem: np.ndarray, copy_rows: int,
                blocks: int = 1, waves: int = 1) -> torch.Tensor:
    """Per-block wrapping int32 sums of a zeroed region after the waves of
    the flat tables dealt over ``blocks`` blocks (:func:`stage_rows`)."""
    sums = torch.zeros(blocks, dtype=torch.int64, device=source.device)
    if waves:
        rows, owner = stage_rows(dst, smem, copy_rows, blocks)
        picked = source.index_select(0, torch.as_tensor(rows.reshape(-1), device=source.device))
        per_copy = picked.view(len(owner), -1).sum(1, dtype=torch.int64)
        sums.index_add_(0, torch.as_tensor(owner, device=source.device), per_copy)
    return wrap_int32(sums)


class BulkCopies:
    """One P4 variant: ``direction`` ('scatter' or 'stage'), copies of
    ``copy_rows`` rows, ``regions`` target regions with a wave of ``wave``
    copies each (by default one per block), dealt over ``blocks`` blocks and
    :data:`WARPS` issuing warps a block, one wait per ``entries`` copies of a
    warp (fewer for a stage, :func:`group_size`)."""

    def __init__(self, direction: str, copy_rows: int, blocks: int = 1, entries: int = WAVE,
                 wave: int = WAVE, target_rows: int = TARGET_ROWS, region_rows: int = REGION_ROWS,
                 regions: int | None = None):
        if direction not in _DIRECTION:
            raise ValueError(f"unknown direction {direction!r}; expected one of {DIRECTIONS}")
        if copy_rows > region_rows:
            raise ValueError(f"a copy of {copy_rows} rows does not fit the {region_rows}-row region")
        self.direction, self.copy_rows, self.blocks, self.entries = direction, copy_rows, blocks, entries
        self.regions = blocks if regions is None else regions
        self.wave, self.region_rows = wave, region_rows
        self.dst, self.smem = copy_tables(copy_rows, self.regions, wave, target_rows, region_rows)
        self.copy_dst, self.copy_smem = flat_tables(self.dst, self.smem, blocks)
        g = spacing(copy_rows)
        self.spacing = g
        self.target_rows = target_rows if self.regions == 1 else self.regions * wave * g
        self.group = group_size(direction, copy_rows, entries, wave, region_rows)
        self.copy_bytes = copy_rows * ROW_BYTES
        self._tables: dict = {}

    @property
    def copies(self) -> int:
        """Copies per launch's wave, over all blocks."""
        return len(self.copy_dst)

    @functools.cached_property
    def slots(self) -> tuple[int, int]:
        """The region slots a block's share uses, for a share of ceil(copies
        / blocks) copies and for one of floor(copies / blocks)."""
        return tuple(share_slots(self.smem, self.copy_rows, n)
                     for n in (-(-self.copies // self.blocks), self.copies // self.blocks))

    @property
    def region_bytes(self) -> int:
        """The shared memory a block takes: the region up to the last slot a
        share uses (slots past it hold nothing and add nothing to a sum)."""
        return self.slots[0].bit_length() * self.spacing * ROW_BYTES

    @functools.cached_property
    def groups(self) -> dict[tuple[int, int], list[list[int]]]:
        return issue_groups(self.direction, self.copy_smem, self.copy_rows, self.group, self.blocks)

    @property
    def waits_per_wave(self) -> int:
        """The most waits one issuing warp makes in a wave: the chain of
        round trips the wave's time holds."""
        return max(len(g) for g in self.groups.values())

    @property
    def name(self) -> str:
        size = self.copy_bytes
        size = f"{size // 1024}KB" if size >= 1024 else f"{size}B"
        deal = "card" if self.regions == 1 and self.blocks > 1 else f"x{self.blocks}"
        name = f"{self.direction}_{size}_{deal}"
        return name if self.entries >= self.wave else f"{name}_e{self.entries}"

    def _device_tables(self, device: torch.device):
        key = str(device)
        if key not in self._tables:
            self._tables[key] = (torch.as_tensor(self.copy_dst, device=device),
                                 torch.as_tensor(self.smem, device=device))
        return self._tables[key]

    def _launch(self, data: torch.Tensor, target: torch.Tensor | None, out: torch.Tensor | None,
                waves: int) -> None:
        with torch.cuda.device(data.device):
            dst, smem = self._device_tables(data.device)
            stream = torch.cuda.current_stream(data.device).cuda_stream
            _library().launch(
                "bulk_copies", _DIRECTION[self.direction], data.data_ptr(), dst.data_ptr(),
                smem.data_ptr(), None if target is None else target.data_ptr(),
                None if out is None else out.data_ptr(), self.copy_bytes, self.copies, waves,
                self.group, self.spacing, self.region_bytes, self.blocks, *self.slots, stream,
            )
        launches[self.name] += 1

    def _check(self, t: torch.Tensor, rows: int, what: str) -> None:
        if t.dtype != torch.int32 or tuple(t.shape) != (rows, ROW_BYTES // 4) or not t.is_contiguous():
            raise ValueError(f"{what} must be contiguous int32 [{rows}, 128], got {t.dtype} {tuple(t.shape)}")

    def scatter(self, image: torch.Tensor, target: torch.Tensor, waves: int = 1) -> torch.Tensor:
        """Copy ``image`` (the [region rows, 128] shared image) into
        ``target`` ([target rows, 128]) ``waves`` times; returns ``target``."""
        if self.direction != "scatter":
            raise ValueError("this variant stages")
        self._check(image, self.region_rows, "image")
        self._check(target, self.target_rows, "target")
        if image.device != target.device:
            raise ValueError("image and target must share a device")
        if target.device.type == "cpu":
            return (scatter_plain(image, target, self.copy_dst, self.copy_smem, self.copy_rows)
                    if waves else target)
        self._launch(image, target, None, waves)
        return target

    def stage(self, source: torch.Tensor, waves: int = 1) -> torch.Tensor:
        """Per-block int32 sums of the region after ``waves`` waves of copies
        from ``source`` ([target rows, 128])."""
        if self.direction != "stage":
            raise ValueError("this variant scatters")
        self._check(source, self.target_rows, "source")
        if source.device.type == "cpu":
            return stage_plain(source, self.copy_dst, self.copy_smem, self.copy_rows, self.blocks, waves)
        out = torch.empty(self.blocks, dtype=torch.int32, device=source.device)
        self._launch(source, None, out, waves)
        return out


@functools.cache
def _library():
    """P4's library, built at first use."""
    from ._build import CLibrary

    p, i, u64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_ulonglong
    lib = CLibrary("bulk_copies", {
        "bulk_copies": [i, p, p, p, p, p, i, i, i, i, i, i, i, u64, u64, p],
        "bulk_copies_max_share": [],
        "bulk_copies_max_slots": [],
        "bulk_copies_warps": [],
    })
    if lib.value("bulk_copies_max_share") < WAVE or lib.value("bulk_copies_warps") != WARPS:
        raise RuntimeError("csrc/bulk_copies.cu and kernels/bulk_copies.py disagree on the share or warps")
    return lib
