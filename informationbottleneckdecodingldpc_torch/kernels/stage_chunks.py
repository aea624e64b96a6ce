"""P5: the staged 7-plane skeleton of a simulated decode iteration, and its
plain version.

Port of the Pallas probe ``scripts/stage_probe.py`` ``build``: per simulated
iteration, a loop over ``N_CHUNKS`` chunks, each staging ``D`` = 7 planes of
``STRIDE`` rows (int32 x 128, 512 B) from a [``HBM_ROWS``, 128] source and
draining them before the next chunk. :func:`stage_schedule` lists one
iteration's copies in the TPU's order and row units, each as (chunk, plane,
first source row, slot); the slots are those of the script's one core:

- ``base``, ``dynsem``, ``vwrite``: plane j of chunk c from row
  ``j PLANE + c STRIDE`` into slot j (one semaphore; one per buffer half;
  the staged planes + 1 copied out after each chunk);
- ``unalign``: the plane bases moved to ``j PLANE + j 1237 + 3``
  (``stage_probe.py:49``);
- ``pipeline``: the TPU K3's double buffer, chunk c into slot
  ``7 (c & 1) + j``, chunk c + 1 started before chunk c is waited for.

The script's ``when``, ``dynread`` and ``dynoff`` probe Mosaic's handling of
an empty ``pl.when`` region and of dynamic vector offsets; every
shared-memory address on the card is dynamic, so they have no counterpart
(:data:`TPU_ONLY`).

A block has 227 KB of shared memory, not a 7 MB chunk, so on the card
(``csrc/stage_chunks.cu``) chunk c is cut into piece-chunks (c, p) of
``piece_rows`` rows: 7 bulk copies, plane j's from row ``base_j + c STRIDE
+ p piece_rows``. Piece-chunks are numbered u = c (STRIDE / piece_rows) + p
and block i of the grid (one per SM) takes u = i (mod grid) in order. A
piece is 32 rows (16 KB), or 16 rows (8 KB) for the variants that also
write the staged planes + 1 into an ``S_out`` in shared memory
(:data:`WRITES`), whose 2 x 7 x 16 KB would fill a block alone. Each block
returns the wrapping int32 sum of every word it staged, plus every word it
wrote to ``S_out``. :class:`StageChunks` launches the kernel for a CUDA
source and counts the launch in :data:`launches`; for a CPU source it runs
:func:`stage_checksums_plain`, the same sums by indexing. There is no
fallback from one to the other.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import numpy as np
import torch

from .bulk_read import ROW_BYTES, wrap_int32

# The script's geometry (stage_probe.py:34-38).
D = 7
STRIDE = 2048
N_CHUNKS = 40
PLANE = N_CHUNKS * STRIDE
HBM_ROWS = D * PLANE + STRIDE + 16384  # 591,872 rows, 303 MB
UNALIGN_STEP, UNALIGN_OFFSET = 1237, 3  # the 'unalign' bases' extra rows, j 1237 + 3
VARIANTS = ("base", "dynsem", "pipeline", "vwrite", "unalign")
TPU_ONLY = ("when", "dynread", "dynoff")
WRITES = ("pipeline", "vwrite")  # variants that also write an S_out
_KERNEL = {"base": 0, "unalign": 0, "dynsem": 1, "pipeline": 2, "vwrite": 3}

# Kernel launches per variant (the plain version does not count).
launches: collections.Counter = collections.Counter()


def misalign(variant: str, j: int) -> int:
    """Extra rows of plane j's base in ``variant``."""
    return j * UNALIGN_STEP + UNALIGN_OFFSET if variant == "unalign" else 0


def stage_schedule(
    variant: str, d: int = D, stride: int = STRIDE, n_chunks: int = N_CHUNKS, plane: int = PLANE
) -> np.ndarray:
    """One iteration's copies of ``variant`` in the TPU's order: int64
    [n_chunks * d, 4], (chunk, plane, first source row, slot)."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; expected one of {VARIANTS}")
    c, j = np.divmod(np.arange(n_chunks * d), d)
    first = j * plane + c * stride + np.array([misalign(variant, k) for k in range(d)])[j]
    slot = (c & 1) * d + j if variant == "pipeline" else j
    return np.stack([c, j, first, slot], 1)


def stage_checksums_plain(
    src: torch.Tensor, bases: np.ndarray, span: int, piece_rows: int, blocks: int,
    iters: int = 1, writes: bool = False,
) -> torch.Tensor:
    """Per-block wrapping int32 sums of ``iters`` iterations over the
    [rows, 128] int32 ``src``: piece-chunk u stages rows ``base_j + u
    piece_rows`` + [0, piece_rows) of every plane j (``span`` rows per plane)
    and goes to block u mod ``blocks``; with ``writes`` each staged word x
    also adds x + 1."""
    units = span // piece_rows
    per_unit = torch.zeros(units, dtype=torch.int64, device=src.device)
    for base in bases:
        rows = src[int(base):int(base) + units * piece_rows].reshape(units, -1)
        per_unit += rows.sum(1, dtype=torch.int64)
    if writes:
        per_unit = 2 * per_unit + len(bases) * piece_rows * src.shape[1]
    block = torch.arange(units, device=src.device) % blocks
    sums = torch.zeros(blocks, dtype=torch.int64, device=src.device).index_add_(0, block, per_unit)
    return wrap_int32((sums & 0xFFFFFFFF) * iters)


class StageChunks:
    """One variant of the skeleton over a source of ``rows`` rows, with the
    script's geometry (or a smaller one). ``bytes_per_iteration`` is what one
    iteration stages from device memory."""

    def __init__(
        self, variant: str, rows: int = HBM_ROWS, d: int = D, stride: int = STRIDE,
        n_chunks: int = N_CHUNKS, plane: int = PLANE, piece_rows: int | None = None,
    ):
        self.variant, self.rows, self.d = variant, rows, d
        self.schedule = stage_schedule(variant, d, stride, n_chunks, plane)
        self.bases = self.schedule[:d, 2]  # plane j's first row at chunk 0
        self.piece_rows = piece_rows or (16 if variant in WRITES else 32)
        if stride % self.piece_rows:
            raise ValueError(f"a chunk of {stride} rows is not a whole number of pieces")
        self.span = n_chunks * stride
        if int(self.bases.max()) + self.span > rows:
            raise ValueError(f"the planes reach past the source's {rows} rows")
        self.units = self.span // self.piece_rows
        self.bytes_per_iteration = d * self.span * ROW_BYTES

    @property
    def name(self) -> str:
        return self.variant

    def plain(self, src: torch.Tensor, blocks: int, iters: int = 1) -> torch.Tensor:
        return stage_checksums_plain(
            src, self.bases, self.span, self.piece_rows, blocks, iters, self.variant in WRITES
        )

    def __call__(self, src: torch.Tensor, iters: int = 1, blocks: int | None = None) -> torch.Tensor:
        """Per-block int32 checksums of ``iters`` iterations over ``src``
        (int32 [rows, 128]) on ``blocks`` blocks (default: one per SM on a
        card, 1 on the CPU)."""
        if src.dtype != torch.int32 or tuple(src.shape) != (self.rows, ROW_BYTES // 4):
            raise ValueError(f"src must be int32 [{self.rows}, 128], got {src.dtype} {tuple(src.shape)}")
        if src.device.type == "cpu":
            return self.plain(src, blocks or 1, iters)
        if not src.is_contiguous():
            raise ValueError("src must be contiguous")
        if blocks is None:
            blocks = torch.cuda.get_device_properties(src.device).multi_processor_count
        out = torch.empty(blocks, dtype=torch.int32, device=src.device)
        bases = (ctypes.c_longlong * self.d)(*(int(b) for b in self.bases))
        with torch.cuda.device(src.device):
            stream = torch.cuda.current_stream(src.device).cuda_stream
            _library().launch(
                "stage_chunks", _KERNEL[self.variant], src.data_ptr(), bases, self.d,
                self.piece_rows, self.units, iters, blocks, out.data_ptr(), stream,
            )
        launches[self.name] += 1
        return out


@functools.cache
def _library():
    """P5's library, built at first use."""
    from ._build import CLibrary

    p, i = ctypes.c_void_p, ctypes.c_int
    lib = CLibrary("stage_chunks", {
        "stage_chunks": [i, p, ctypes.POINTER(ctypes.c_longlong), i, i, i, i, i, p, p],
        "stage_chunks_max_planes": [],
    })
    if lib.value("stage_chunks_max_planes") != D:
        raise RuntimeError("csrc/stage_chunks.cu and kernels/stage_chunks.py disagree on the planes")
    return lib
