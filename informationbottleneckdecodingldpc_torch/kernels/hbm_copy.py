"""Device-memory copy K6 and its plain version.

Port of the Pallas copy pipeline of ``scripts/bench_matrix.py``
``measure_hbm_bandwidth``: ``csrc/hbm_copy.cu`` copies ``src`` to ``dst``
``passes`` times through a ring of shared-memory stages filled and drained by
bulk copies, one persistent block per SM taking every grid-th whole chunk,
the ragged tail copied by threads (:func:`copy_spans`). For a
CUDA tensor :func:`copy` launches the kernel and counts the launch in
:data:`launches`; for a CPU tensor it runs the plain version,
``dst.copy_(src)`` per pass. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import functools

import torch

# Kernel launches (the plain version does not count).
launches = {"hbm_copy": 0}
CHUNK_BYTES = 16 * 1024  # kChunk in csrc/hbm_copy.cu


def copy_spans(nbytes: int, blocks: int) -> list[tuple[int, int, int, str]]:
    """The byte ranges one pass of the kernel copies, as ``(start, stop,
    block, by)``: chunk k, moved by bulk copies ('bulk'), by block k %
    ``blocks``, and the tail past the last whole chunk by the threads of the
    last block ('threads'); mirrors the kernel's schedule for a grid of
    ``blocks`` blocks."""
    chunks = nbytes // CHUNK_BYTES
    spans = [
        (k * CHUNK_BYTES, (k + 1) * CHUNK_BYTES, k % blocks, "bulk") for k in range(chunks)
    ]
    if nbytes > chunks * CHUNK_BYTES:
        spans.append((chunks * CHUNK_BYTES, nbytes, blocks - 1, "threads"))
    return spans


def copy_plain(src: torch.Tensor, dst: torch.Tensor, passes: int = 1) -> None:
    for _ in range(passes):
        dst.copy_(src)


def copy(src: torch.Tensor, dst: torch.Tensor, passes: int = 1) -> None:
    """Copy ``src`` into ``dst`` (same dtype, shape and device, contiguous,
    16-byte aligned) ``passes`` times."""
    if src.device.type == "cpu":
        copy_plain(src, dst, passes)
        return
    if (src.dtype, src.shape, src.device) != (dst.dtype, dst.shape, dst.device):
        raise ValueError("src and dst must have one dtype, shape and device")
    if not (src.is_contiguous() and dst.is_contiguous()):
        raise ValueError("src and dst must be contiguous")
    if src.data_ptr() % 16 or dst.data_ptr() % 16:
        raise ValueError("the bulk copies need 16-byte aligned src and dst")
    nbytes = src.numel() * src.element_size()
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        _library().launch("hbm_copy", src.data_ptr(), dst.data_ptr(), nbytes, passes, stream)
    launches["hbm_copy"] += 1


@functools.cache
def _library():
    """K6's library, built at first use; its chunk must be
    :func:`copy_spans`'s."""
    from ._build import CLibrary

    p, i = ctypes.c_void_p, ctypes.c_int
    lib = CLibrary(
        "hbm_copy",
        {"hbm_copy": [p, p, ctypes.c_longlong, i, p], "hbm_copy_chunk_bytes": []},
    )
    if lib.value("hbm_copy_chunk_bytes") != CHUNK_BYTES:
        raise RuntimeError(f"csrc/hbm_copy.cu copies chunks of "
                           f"{lib.value('hbm_copy_chunk_bytes')} bytes, the wrapper's {CHUNK_BYTES}")
    return lib
