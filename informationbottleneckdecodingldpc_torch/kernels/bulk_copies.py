"""P4: waves of bulk copies at table-driven offsets, scatter and stage, and
their plain versions.

Port of the Pallas probe ``scripts/dma_probe.py`` (``build``: waves of 512
dynamic DMAs of L rows, scatter VMEM -> HBM or stage HBM -> VMEM;
``build_tiny_loops``: the same waves waited for a few entries at a time).
Rows are the TPU's 512 bytes. :func:`copy_tables` makes the tables as
``dma_probe.py:38-44`` makes them: copy k of a wave goes to device-memory
row ``perm[k] * G`` (G = max(L, 8 rows), a seeded permutation of the
target's slots) and to shared-memory row ``(k mod (region / G)) * G`` of a
192 KB region. With more than one block, block b gets a target region of its
own of ``wave * G`` rows and a permutation of its slots.

``csrc/bulk_copies.cu`` runs them on the card: ``scatter`` copies a 192 KB
shared image (loaded from ``image`` at the start) to the target, one bulk
group and wait per ``entries`` copies; ``stage`` copies from the source into
the region, one mbarrier phase per group of at most min(entries, slots,
(2^20 - 1) / L) copies (:func:`group_size`), and returns the wrapping int32
sum of each block's region afterwards. :class:`BulkCopies` launches the
kernel for CUDA tensors and counts the launch in :data:`launches`; for CPU
tensors it runs the plain versions (:func:`scatter_plain`, an
``index_copy_`` of the rows :func:`scatter_rows` lists, and
:func:`stage_plain`). There is no fallback from one to the other.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import numpy as np
import torch

from .bulk_read import ROW_BYTES, wrap_int32

WAVE = 512  # copies per wave
TARGET_ROWS = 1 << 20  # 512 MB: one block's target, the TPU probe's
REGION_ROWS = 384  # 192 KB of shared memory
MIN_SPACING_ROWS = 8  # 4 KB between two copies' slots
MAX_TX_BYTES = (1 << 20) - 1  # an mbarrier phase's transaction count
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
    of the copies of one wave, from numpy's generator seeded 0 as the TPU
    probe's. One block draws ``rng.permutation(slots)`` over ``target_rows``;
    block b of several draws a permutation of its own ``wave`` slots, in a
    region starting at row ``b * wave * G``."""
    g = spacing(copy_rows)
    rng = np.random.default_rng(0)
    slots = target_rows // g if blocks == 1 else wave
    dst = np.stack([b * slots * g + rng.permutation(slots)[:wave] * g for b in range(blocks)])
    smem = (np.arange(wave) % (region_rows // g)) * g
    return dst.astype(np.int32), smem.astype(np.int32)


def group_size(direction: str, copy_rows: int, entries: int, wave: int = WAVE,
               region_rows: int = REGION_ROWS) -> int:
    """Copies per wait: ``entries`` for a scatter; for a stage also at most
    the region's slots and what one mbarrier phase can count."""
    group = min(entries, wave)
    if direction == "stage":
        group = min(group, region_rows // spacing(copy_rows), MAX_TX_BYTES // (copy_rows * ROW_BYTES))
    return group


def scatter_rows(dst: np.ndarray, smem: np.ndarray, copy_rows: int) -> tuple[np.ndarray, np.ndarray]:
    """Target rows and image rows of one wave of every block's copies, in
    copy order (int64)."""
    span = np.arange(copy_rows)
    to = (dst[:, :, None].astype(np.int64) + span).reshape(-1)
    frm = np.broadcast_to(smem[None, :, None] + span, dst.shape + (copy_rows,)).reshape(-1)
    return to, frm.astype(np.int64)


def scatter_plain(image: torch.Tensor, target: torch.Tensor, dst: np.ndarray, smem: np.ndarray,
                  copy_rows: int) -> torch.Tensor:
    """Every block's copies of ``image`` rows into ``target`` ([rows, 128]
    int32), by one ``index_copy_``."""
    to, frm = (torch.as_tensor(a, device=target.device) for a in scatter_rows(dst, smem, copy_rows))
    return target.index_copy_(0, to, image.index_select(0, frm))


def stage_plain(source: torch.Tensor, dst: np.ndarray, smem: np.ndarray, copy_rows: int,
                waves: int = 1) -> torch.Tensor:
    """Per-block wrapping int32 sums of a zeroed region after the waves: each
    slot holds the rows of the last copy into it."""
    blocks, wave = dst.shape
    if waves == 0:
        return torch.zeros(blocks, dtype=torch.int32, device=source.device)
    last = {int(s): k for k, s in enumerate(smem)}
    rows = dst[:, sorted(last.values())][:, :, None] + np.arange(copy_rows)
    picked = source.index_select(0, torch.as_tensor(rows.reshape(-1), device=source.device))
    return wrap_int32(picked.view(blocks, -1).sum(1, dtype=torch.int64))


class BulkCopies:
    """One P4 variant: ``direction`` ('scatter' or 'stage'), copies of
    ``copy_rows`` rows, ``blocks`` blocks, one wait per ``entries`` copies
    (fewer for a stage, :func:`group_size`)."""

    def __init__(self, direction: str, copy_rows: int, blocks: int = 1, entries: int = WAVE,
                 wave: int = WAVE, target_rows: int = TARGET_ROWS, region_rows: int = REGION_ROWS):
        if direction not in _DIRECTION:
            raise ValueError(f"unknown direction {direction!r}; expected one of {DIRECTIONS}")
        if copy_rows > region_rows:
            raise ValueError(f"a copy of {copy_rows} rows does not fit the {region_rows}-row region")
        self.direction, self.copy_rows, self.blocks, self.entries = direction, copy_rows, blocks, entries
        self.wave, self.region_rows = wave, region_rows
        self.dst, self.smem = copy_tables(copy_rows, blocks, wave, target_rows, region_rows)
        g = spacing(copy_rows)
        self.target_rows = target_rows if blocks == 1 else blocks * wave * g
        self.group = group_size(direction, copy_rows, entries, wave, region_rows)
        self.waits_per_wave = -(-wave // self.group)
        self.copy_bytes = copy_rows * ROW_BYTES
        self._tables: dict = {}

    @property
    def name(self) -> str:
        size = self.copy_bytes
        size = f"{size // 1024}KB" if size >= 1024 else f"{size}B"
        name = f"{self.direction}_{size}_x{self.blocks}"
        return name if self.entries >= self.wave else f"{name}_e{self.entries}"

    def _device_tables(self, device: torch.device):
        key = str(device)
        if key not in self._tables:
            self._tables[key] = (torch.as_tensor(self.dst, device=device),
                                 torch.as_tensor(self.smem, device=device))
        return self._tables[key]

    def _launch(self, data: torch.Tensor, target: torch.Tensor | None, out: torch.Tensor | None,
                waves: int) -> None:
        dst, smem = self._device_tables(data.device)
        with torch.cuda.device(data.device):
            stream = torch.cuda.current_stream(data.device).cuda_stream
            _library().launch(
                "bulk_copies", _DIRECTION[self.direction], data.data_ptr(), dst.data_ptr(),
                smem.data_ptr(), None if target is None else target.data_ptr(),
                None if out is None else out.data_ptr(), self.copy_bytes, self.wave, waves,
                self.group, self.region_rows * ROW_BYTES, self.blocks, stream,
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
            return scatter_plain(image, target, self.dst, self.smem, self.copy_rows) if waves else target
        self._launch(image, target, None, waves)
        return target

    def stage(self, source: torch.Tensor, waves: int = 1) -> torch.Tensor:
        """Per-block int32 sums of the region after ``waves`` waves of copies
        from ``source`` ([target rows, 128])."""
        if self.direction != "stage":
            raise ValueError("this variant scatters")
        self._check(source, self.target_rows, "source")
        if source.device.type == "cpu":
            return stage_plain(source, self.dst, self.smem, self.copy_rows, waves)
        out = torch.empty(self.blocks, dtype=torch.int32, device=source.device)
        self._launch(source, None, out, waves)
        return out


@functools.cache
def _library():
    """P4's library, built at first use."""
    from ._build import CLibrary

    p, i = ctypes.c_void_p, ctypes.c_int
    lib = CLibrary("bulk_copies", {
        "bulk_copies": [i, p, p, p, p, p, i, i, i, i, i, i, p],
        "bulk_copies_max_wave": [],
    })
    if lib.value("bulk_copies_max_wave") < WAVE:
        raise RuntimeError("csrc/bulk_copies.cu holds fewer table entries than a wave")
    return lib
