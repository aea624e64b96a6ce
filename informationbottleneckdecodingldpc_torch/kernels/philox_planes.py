"""Philox4x32-10 random planes on the card, for the Monte-Carlo engine.

The engine's draws (``sim/rng.py``) give every codeword its own column of
each random plane, keyed by the step and counted by the global codeword
index. On a CUDA device :func:`plane` launches ``csrc/philox_planes.cu``,
one thread per (4-word group, codeword) and one launch per plane, and counts
the launch in :data:`launches`; the plain version is ``sim/rng.py``
``plane_plain``, which ``sim.rng.draw`` runs for the CPU. This function
takes no CPU device: there is no fallback from one to the other.

The kernel replaces XLA code of the JAX engine, not a Pallas kernel: the
``vmap`` of ``jax.random`` over per-codeword keys
(``informationbottleneckdecodingldpc_tpu/sim/engine.py:376-391``).
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

# Stream id (third counter word) of each plane kind, in the order of the
# JAX engine's three-way key split: info bits, noise, inversion uniforms.
STREAMS = {"bits": 0, "normal": 1, "uniform": 2}
ELEMENTS_PER_GROUP = {"bits": 128, "normal": 2, "uniform": 4}  # per 4-word group
DTYPES = {"bits": torch.int8, "normal": torch.float32, "uniform": torch.float32}

# Kernel launches per plane kind (the plain version does not count).
launches: collections.Counter = collections.Counter()


def plane(
    kind: str, key: tuple[int, int], rows: int, offset: int, batch: int,
    device: torch.device | str,
) -> torch.Tensor:
    """The [rows, batch] plane of ``kind`` of codewords [offset, offset +
    batch) under the 64-bit ``key`` (two words), computed on the CUDA
    ``device`` by one kernel launch."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the Philox kernel needs a cuda device, got {device}")
    out = torch.empty((rows, batch), dtype=DTYPES[kind], device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        _library().launch(
            "philox_plane", STREAMS[kind], out.data_ptr(), key[0], key[1], offset, rows,
            batch, stream,
        )
    launches[kind] += 1
    return out


@functools.cache
def _library():
    """The Philox kernel's library, built at first use."""
    from ._build import CLibrary

    u, i = ctypes.c_uint, ctypes.c_int
    return CLibrary("philox_planes", {
        "philox_plane": [i, ctypes.c_void_p, u, u, u, i, i, ctypes.c_void_p],
    })
