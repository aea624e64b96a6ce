"""Device-memory copy K6 and its plain version.

Port of the Pallas copy pipeline of ``scripts/bench_matrix.py``
``measure_hbm_bandwidth``: ``csrc/hbm_copy.cu`` copies ``src`` to ``dst``
``passes`` times with 16-byte vectors in a grid-stride loop over all SMs.
For a CUDA tensor :func:`copy` launches the kernel and counts the launch in
:data:`launches`; for a CPU tensor it runs the plain version,
``dst.copy_(src)`` per pass. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import functools

import torch

# Kernel launches (the plain version does not count).
launches = {"hbm_copy": 0}


def copy_plain(src: torch.Tensor, dst: torch.Tensor, passes: int = 1) -> None:
    for _ in range(passes):
        dst.copy_(src)


def copy(src: torch.Tensor, dst: torch.Tensor, passes: int = 1) -> None:
    """Copy ``src`` into ``dst`` (same dtype, shape and device, contiguous,
    a whole number of 16-byte vectors) ``passes`` times."""
    if src.device.type == "cpu":
        copy_plain(src, dst, passes)
        return
    if (src.dtype, src.shape, src.device) != (dst.dtype, dst.shape, dst.device):
        raise ValueError("src and dst must have one dtype, shape and device")
    if not (src.is_contiguous() and dst.is_contiguous()):
        raise ValueError("src and dst must be contiguous")
    nbytes = src.numel() * src.element_size()
    if nbytes % 16:
        raise ValueError(f"the copy moves 16-byte vectors, got {nbytes} bytes")
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        _library().launch(
            "hbm_copy", src.data_ptr(), dst.data_ptr(), nbytes // 16, passes, stream
        )
    launches["hbm_copy"] += 1


@functools.cache
def _library():
    """K6's library, built at first use."""
    from ._build import CLibrary

    p, i = ctypes.c_void_p, ctypes.c_int
    return CLibrary("hbm_copy", {"hbm_copy": [p, p, ctypes.c_longlong, i, p]})
