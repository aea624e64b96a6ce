"""The Monte-Carlo engine's channel input on the card: Philox4x32-10 draws and
what the decoder reads of them, in one kernel.

The engine's draws (``sim/rng.py``) give every codeword its own column of
each random plane, keyed by the step and counted by the global codeword
index. ``csrc/philox_planes.cu`` is one template over (draw, consumer): its
identity consumer writes a plane (:func:`plane`, the bits of the encoded
chain and ``rng.draw``'s uniform and normal planes), its other consumers turn
the draws in registers into the decoder's input (:func:`channel_input`, one
launch per Monte-Carlo step, the kinds of :data:`FUSED`). A thread takes
4 adjacent codewords of one 4-word group row on a 2-D grid that the C
launcher derives from the shape. Each launch counts in :data:`launches` under its
kind; the plain versions are ``sim/rng.py`` ``plane_plain`` and
``channel_input_plain``, which ``sim.rng`` runs for the CPU. These functions
take no CPU device: there is no fallback from one to the other.

The kernel replaces XLA code of the JAX engine, not a Pallas kernel: the
``vmap`` of ``jax.random`` over per-codeword keys and the sampling, AWGN and
quantizer ops XLA fuses around it
(``informationbottleneckdecodingldpc_tpu/sim/engine.py:374-438``).
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math

import numpy as np
import torch

# Stream id (third counter word) of each plane kind, in the order of the
# JAX engine's three-way key split: info bits, noise, inversion uniforms.
STREAMS = {"bits": 0, "normal": 1, "uniform": 2}
ELEMENTS_PER_GROUP = {"bits": 128, "normal": 2, "uniform": 4}  # per 4-word group
DTYPES = {"bits": torch.int8, "normal": torch.float32, "uniform": torch.float32}

# The fused kinds: kind -> (its draw, what it writes, whether it reads the
# transmitted codeword). 'clusters' are int32 counts of the thresholds below
# the draw (cdf[1:-1] for a uniform, limits[1:] for y), 'llrs' the float32
# LLR of that cluster, 'true' float32 2y / sigma^2.
FUSED = {
    "uniform_clusters": ("uniform", "clusters", False),  # all-zeros, IB
    "uniform_llrs": ("uniform", "llrs", False),  # all-zeros, min-sum / BP quantized
    "normal_true": ("normal", "true", False),  # all-zeros, min-sum / BP true LLRs
    "encoded_clusters": ("normal", "clusters", True),  # encoded, IB
    "encoded_llrs": ("normal", "llrs", True),  # encoded, min-sum / BP quantized
    "encoded_true": ("normal", "true", True),  # encoded, min-sum / BP true LLRs
}
# The C interface's kind numbers (csrc/philox_planes.cu Kind).
KINDS = {k: n for n, k in enumerate(("bits", "normal", "uniform", *FUSED))}
SLOTS = 32  # threshold slots of the kernel's binary search: at most 31 thresholds

# Kernel launches per kind, plane or fused (the plain versions do not count).
launches: collections.Counter = collections.Counter()


def draw_of(kind: str) -> str:
    """The plane kind (:data:`STREAMS`) a plane or fused kind draws."""
    return FUSED[kind][0] if kind in FUSED else kind


def _cuda(device: torch.device | str) -> torch.device:
    """``device``, which must be a CUDA device, with its index."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the Philox kernel needs a cuda device, got {device}")
    return device if device.index is not None else torch.device("cuda", torch.cuda.current_device())


def _launch(kind: str, out: torch.Tensor, key: tuple[int, int], offset: int, *,
            codeword: torch.Tensor | None = None, thresholds: torch.Tensor | None = None,
            llrs: torch.Tensor | None = None, s: float = 0.0, inv_sigma2: float = 0.0) -> None:
    rows, batch = out.shape
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        _library().launch(
            "philox_channel_input", KINDS[kind], out.data_ptr(), ptr(codeword), ptr(thresholds),
            0 if thresholds is None else thresholds.numel(), ptr(llrs),
            0 if llrs is None else llrs.numel(), s, inv_sigma2, key[0], key[1], offset, rows,
            batch, stream,
        )
    launches[kind] += 1


def plane(
    kind: str, key: tuple[int, int], rows: int, offset: int, batch: int,
    device: torch.device | str,
) -> torch.Tensor:
    """The [rows, batch] plane of ``kind`` of codewords [offset, offset +
    batch) under the 64-bit ``key`` (two words), computed on the CUDA
    ``device`` by one kernel launch."""
    device = _cuda(device)
    out = torch.empty((rows, batch), dtype=DTYPES[kind], device=device)
    _launch(kind, out, key, offset)
    return out


def _table(t: torch.Tensor, device: torch.device, most: int, what: str) -> torch.Tensor:
    if t.dtype != torch.float32 or t.device != device or not 1 <= t.numel() <= most:
        raise ValueError(f"{what} must be 1 to {most} float32 values on {device}, got "
                         f"{t.numel()} {t.dtype} on {t.device}")
    return t.contiguous()


def channel_input(
    kind: str, key: tuple[int, int], rows: int, offset: int, batch: int,
    device: torch.device | str, tables, sigma2: float | None = None,
    codeword: torch.Tensor | None = None,
) -> torch.Tensor:
    """The decoder's [rows, batch] input of fused ``kind`` for codewords
    [offset, offset + batch) under ``key``, computed on the CUDA ``device``
    by one kernel launch from the quantizer ``tables``
    (``DeviceQuantizerTables`` on that device), the noise variance
    ``sigma2`` (float32-representable; the AWGN kinds) and, for the encoded
    kinds, the transmitted int8 ``codeword`` [rows, batch]."""
    device = _cuda(device)
    draw, consumer, encoded = FUSED[kind]
    args = {}
    if encoded:
        if (codeword is None or codeword.dtype != torch.int8 or codeword.device != device
                or tuple(codeword.shape) != (rows, batch) or not codeword.is_contiguous()):
            raise ValueError(f"{kind} reads a contiguous int8 codeword [{rows}, {batch}] on {device}")
        args["codeword"] = codeword
    if consumer in ("clusters", "llrs"):
        thresholds = tables.cdf[1:-1] if draw == "uniform" else tables.limits[1:]
        args["thresholds"] = _table(thresholds, device, SLOTS - 1, "the thresholds")
        if consumer == "llrs":
            args["llrs"] = _table(tables.llrs, device, SLOTS, "the llrs")
    if draw == "normal":
        args["s"] = float(np.float32(math.sqrt(sigma2)))
        args["inv_sigma2"] = float(np.float32(1.0) / np.float32(sigma2))
    dtype = torch.int32 if consumer == "clusters" else torch.float32
    out = torch.empty((rows, batch), dtype=dtype, device=device)
    _launch(kind, out, key, offset, **args)
    return out


@functools.cache
def _library():
    """The kernel's library, built at first use."""
    from ._build import CLibrary

    u, i, f, p = ctypes.c_uint, ctypes.c_int, ctypes.c_float, ctypes.c_void_p
    return CLibrary("philox_planes", {
        "philox_channel_input": [i, p, p, p, i, p, i, f, f, u, u, u, i, i, p],
    })
