"""P2/P3: device-memory reads staged into shared memory by bulk copies, and
their plain version.

Port of the Pallas probes ``scripts/read_bw_probe.py`` ``build`` (reads
through a depth-4 ring of slots, 1 or 7 streams) and
``scripts/read_bw_probe2.py`` ``build`` (offsets from a table; 2 stages of 7
planes). :func:`read_schedule` lists a variant's units in order, each as
(first source row, slot), in the TPU's 512-byte rows and with its address
arithmetic:

- ``seq``: unit u reads rows from ``u L``;
- ``strided``: 7 streams ``rows / 8`` apart, c = u // 7, j = u % 7, rows
  from ``j rows/8 + c L`` (``read_bw_probe.py:35-41``);
- ``table``: the same offsets from an int32 table in device memory;
- ``nested``: stage c reads chunk c of the 7 planes into slots
  ``7 (c & 1) + j`` (``read_bw_probe2.py:48-74``).

The slots are those of one sequence, as the TPU's single core ran it
(:data:`RING`). On the card (``csrc/bulk_read.cu``) block i of the grid
takes the units (stages for ``nested``) u = i (mod grid) through its own
ring and returns the wrapping int32 sum of every word it staged. The card's
ring is sized by bytes, not by the TPU's depth: :func:`ring_slots` slots of
a chunk, :data:`RING_BYTES` in flight per SM split between its blocks
(``nested`` keeps its 2 x 7 slots), with the table variant's share of the
table staged in shared memory after them (:func:`ring_shared_bytes`).
:class:`BulkRead` launches the kernel for a CUDA source and counts the
launch in :data:`launches`; for a CPU source it runs
:func:`read_checksums_plain`, the same per-block sums by indexing. There is
no fallback from one to the other.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import numpy as np
import torch

ROW_BYTES = 512  # the TPU's [1, 128] int32 row, the schedules' unit
SOURCE_ROWS = 1 << 19  # 256 MB, five times the 50 MB L2
STREAMS = 7  # interleaved streams (DVB-S2's check-node planes)
RING = 4  # slots of the TPU's ring (read_schedule's slot column)
RING_BYTES = 64 * 1024  # the card's ring: bytes in flight per SM (kRingBytes)
MIN_SLOTS = 4  # slots per SM at least (kMinSlots)
MAX_SLOTS = 64  # slots of a block's ring at most (kMaxSlots)
# Shared memory a block may hold (static and dynamic), and the ring
# kernel's static part: a full and an empty barrier per slot, block_sum's
# 32 words.
BLOCK_SHARED = 232448
RING_STATIC_SHARED = 2 * MAX_SLOTS * 8 + 32 * 4
VARIANTS = ("seq", "strided", "table", "nested")
# The probes' variants, (variant, chunk KB): P2 streams 1 and 7 at three
# chunk sizes, P3 seq / table / nested at two (nested's 2 x 7 slots of 16 KB
# fill a block's shared memory).
PROBES = {
    "p2": [(v, kb) for v in ("seq", "strided") for kb in (4, 16, 48)],
    "p3": [(v, kb) for v in ("seq", "table", "nested") for kb in (4, 16)],
}
_VARIANT = {v: k for k, v in enumerate(VARIANTS)}

# Kernel launches per variant name (``BulkRead.name``); the plain version
# does not count.
launches: collections.Counter = collections.Counter()


def wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values to int32, modulo 2^32 (two's complement)."""
    return (((x & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000).to(torch.int32)


def read_schedule(variant: str, rows: int, chunk_rows: int, streams: int = STREAMS) -> np.ndarray:
    """The units of ``variant`` over a source of ``rows`` rows in chunks of
    ``chunk_rows``: int64 [units, 2], (first source row, slot) in order."""
    if variant == "seq":
        first = np.arange(rows // chunk_rows) * chunk_rows
        return np.stack([first, np.arange(len(first)) % RING], 1)
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; expected one of {VARIANTS}")
    plane = rows // 8
    n_ch = plane // chunk_rows
    c, j = np.divmod(np.arange(n_ch * streams), streams)
    first = j * plane + c * chunk_rows
    slot = (c & 1) * streams + j if variant == "nested" else np.arange(len(first)) % RING
    return np.stack([first, slot], 1)


def ring_slots(chunk_rows: int, blocks_per_sm: int = 1) -> int:
    """Slots of a block's ring on the card (``ring_slots`` in
    ``csrc/bulk_read.cu``): :data:`RING_BYTES` per SM in chunks, at least
    :data:`MIN_SLOTS`, split between the SM's blocks; at least 1 and at most
    :data:`MAX_SLOTS` a block."""
    per_sm = max(MIN_SLOTS, RING_BYTES // (chunk_rows * ROW_BYTES))
    return max(1, min(MAX_SLOTS, per_sm // blocks_per_sm))


def ring_shared_bytes(variant: str, chunk_rows: int, units: int, blocks: int, sms: int) -> int:
    """Dynamic shared memory of a block of a ring variant on ``blocks``
    blocks over ``sms`` SMs: its slots and, for ``table``, the largest
    block's share of the table, rounded up to 16 bytes."""
    ring = ring_slots(chunk_rows, -(-blocks // sms)) * chunk_rows * ROW_BYTES
    if variant != "table":
        return ring
    share = -(-units // blocks)  # block 0's units, the most of any block
    return ring + -(-4 * share // 16) * 16


def read_checksums_plain(
    src: torch.Tensor, schedule: np.ndarray, chunk_rows: int, blocks: int, passes: int = 1,
    per_step: int = 1,
) -> torch.Tensor:
    """Per-block wrapping int32 sums of ``passes`` passes over the units of
    ``schedule`` of the [rows, 128] int32 ``src``, step s (``per_step``
    units) going to block s mod ``blocks``, as the kernel splits them."""
    first = torch.as_tensor(schedule[:, 0], device=src.device)
    rows = (first[:, None] + torch.arange(chunk_rows, device=src.device)).reshape(-1)
    unit_sums = src.index_select(0, rows).view(len(first), -1).sum(1, dtype=torch.int64)
    block = (torch.arange(len(first), device=src.device) // per_step) % blocks
    sums = torch.zeros(blocks, dtype=torch.int64, device=src.device).index_add_(0, block, unit_sums)
    return wrap_int32((sums & 0xFFFFFFFF) * passes)


class BulkRead:
    """One read variant at one chunk size over a source of ``rows`` rows.
    ``bytes_per_pass`` is what a pass reads from device memory."""

    def __init__(self, variant: str, chunk_rows: int, rows: int = SOURCE_ROWS):
        self.variant, self.chunk_rows, self.rows = variant, chunk_rows, rows
        self.schedule = read_schedule(variant, rows, chunk_rows)
        self.units = len(self.schedule)
        self.per_step = STREAMS if variant == "nested" else 1
        self.bytes_per_pass = self.units * chunk_rows * ROW_BYTES
        self._tables: dict = {}

    def slots(self, blocks_per_sm: int = 1) -> int:
        """Slots of a block on the card: the ring's, or nested's 2 x 7."""
        return 2 * STREAMS if self.variant == "nested" else ring_slots(self.chunk_rows, blocks_per_sm)

    def bytes_in_flight_per_sm(self, blocks_per_sm: int = 1) -> int:
        """What a full ring keeps in flight on one SM."""
        return blocks_per_sm * self.slots(blocks_per_sm) * self.chunk_rows * ROW_BYTES

    @property
    def name(self) -> str:
        kb = self.chunk_rows * ROW_BYTES / 1024
        return f"{self.variant}_{kb:g}KB"

    def plain(self, src: torch.Tensor, blocks: int, passes: int = 1) -> torch.Tensor:
        return read_checksums_plain(src, self.schedule, self.chunk_rows, blocks, passes, self.per_step)

    def __call__(self, src: torch.Tensor, passes: int = 1, blocks: int | None = None) -> torch.Tensor:
        """Per-block int32 checksums of ``passes`` passes over ``src`` (int32
        [rows, 128]) on ``blocks`` blocks (default: one per SM on a card,
        1 on the CPU)."""
        if src.dtype != torch.int32 or tuple(src.shape) != (self.rows, ROW_BYTES // 4):
            raise ValueError(f"src must be int32 [{self.rows}, 128], got {src.dtype} {tuple(src.shape)}")
        if src.device.type == "cpu":
            return self.plain(src, blocks or 1, passes)
        if not src.is_contiguous():
            raise ValueError("src must be contiguous")
        if blocks is None:
            blocks = torch.cuda.get_device_properties(src.device).multi_processor_count
        table = None
        if self.variant == "table":
            key = str(src.device)
            if key not in self._tables:
                self._tables[key] = torch.as_tensor(
                    self.schedule[:, 0].astype(np.int32), device=src.device
                )
            table = self._tables[key]
        out = torch.empty(blocks, dtype=torch.int32, device=src.device)
        with torch.cuda.device(src.device):
            stream = torch.cuda.current_stream(src.device).cuda_stream
            _library().launch(
                "bulk_read", _VARIANT[self.variant], src.data_ptr(),
                None if table is None else table.data_ptr(), out.data_ptr(), self.rows // 8,
                self.chunk_rows, STREAMS, self.units, passes, blocks, stream,
            )
        launches[self.name] += 1
        return out


@functools.cache
def _library():
    """P2/P3's library, built at first use."""
    from ._build import CLibrary

    p, i = ctypes.c_void_p, ctypes.c_int
    lib = CLibrary("bulk_read", {
        "bulk_read": [i, p, p, p, ctypes.c_longlong, i, i, i, i, i, p],
        "bulk_read_slots": [i, i],
    })
    for chunk_rows in sorted({kb * 1024 // ROW_BYTES for p in PROBES.values() for _, kb in p}):
        for per_sm in (1, 2):
            if lib.value("bulk_read_slots", chunk_rows, per_sm) != ring_slots(chunk_rows, per_sm):
                raise RuntimeError("csrc/bulk_read.cu and kernels/bulk_read.py disagree on the "
                                   f"ring's slots at {chunk_rows} rows, {per_sm} blocks per SM")
    return lib
