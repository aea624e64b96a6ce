"""P1: packed-LUT column builds on CUDA cores and on tensor cores, and their
plain version.

Port of the Pallas probe ``scripts/mxu_col_probe.py`` (``vpu_variant``,
``mxu_variant``). Every element runs the probe's chain, ``loops`` steps::

    cols[k] = packed[k, b]                  (k < W)
    e = extract(cols, b & (T1 - 1), fb)     (ops/lut_fold.py _extract)
    b = (e + b) & (T1 - 1);  acc += cols[0]

and the result is ``acc + b`` in wrapping int32 (``b0`` is taken mod T1).
:data:`CONFIGS` holds the probe's two packings, (T1, fb, W) = (16, 4, 2) and
(32, 5, 5), the second split packing (four words of low nibbles and one of
high bits). ``csrc/lut_columns.cu`` builds the columns two ways:
``cuda_cores`` (W shared-memory loads per step) and ``tensor_cores`` (a
one-hot f16 ``mma`` against the packed words' bytes). For a CUDA tensor
:func:`columns_chain` launches the kernel of ``variant`` and counts the
launch in :data:`launches`; for a CPU tensor it runs
:func:`columns_chain_plain`, which computes the chain by indexing. There is
no fallback from one to the other.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import numpy as np
import torch

from .bulk_read import wrap_int32

VARIANTS = ("cuda_cores", "tensor_cores")
CONFIGS = {16: (4, 2), 32: (5, 5)}  # T1 -> (field bits, words per column)
_VARIANT = {"cuda_cores": 0, "tensor_cores": 1}
_BLOCK_ELEMENTS = 1024  # a multiple of both kernels' elements per block

# Kernel launches per variant name (:func:`variant_name`); the plain version
# does not count.
launches: collections.Counter = collections.Counter()


def variant_name(variant: str, t1: int) -> str:
    return f"{variant}_T{t1}"


def probe_inputs(t1: int, elements: int, seed: int = 2) -> tuple[np.ndarray, np.ndarray]:
    """Seeded numpy inputs: ``packed`` int32 [W, T1] with words in
    [0, 2^31) and ``b0`` int32 [elements] in [0, T1), drawn as the JAX
    probe's ``mxu_variant`` draws them (one generator, packed first)."""
    w = CONFIGS[t1][1]
    rng = np.random.default_rng(seed)
    packed = rng.integers(0, 2**31, (w, t1)).astype(np.int32)
    return packed, rng.integers(0, t1, elements).astype(np.int32)


def extract(cols: list[torch.Tensor], a: torch.Tensor, fb: int) -> torch.Tensor:
    """Field ``a`` of the packed column ``cols`` (words as int64 in
    [0, 2^32)), with ``ops/lut_fold.py`` ``_extract``'s semantics: a word
    select and a shift; ``fb`` 5 is split packing."""
    if fb == 5:
        low_cols, hi = cols[:-1], cols[-1]
        word = low_cols[0]
        for k in range(1, len(low_cols)):
            word = torch.where((a >> 3) == k, low_cols[k], word)
        return ((word >> (4 * (a & 7))) & 15) | (((hi >> (a & 31)) & 1) << 4)
    per = 32 // fb
    shift = per.bit_length() - 1
    word = cols[0]
    for k in range(1, len(cols)):
        word = torch.where((a >> shift) == k, cols[k], word)
    return (word >> (fb * (a & (per - 1)))) & ((1 << fb) - 1)


def columns_chain_plain(packed: torch.Tensor, b0: torch.Tensor, loops: int) -> torch.Tensor:
    """The chain by indexing, in int64 with the words as unsigned 32-bit
    values, wrapped to int32 at the end: int32 like ``b0``."""
    w, t1 = packed.shape
    fb = CONFIGS[t1][0]
    words = packed.long() & 0xFFFFFFFF
    b = b0.long() & (t1 - 1)
    acc = torch.zeros_like(b)
    for _ in range(loops):
        cols = [words[k][b] for k in range(w)]
        e = extract(cols, b, fb)
        acc = acc + cols[0]
        b = (e + b) & (t1 - 1)
    return wrap_int32(acc + b)


def _check(packed: torch.Tensor, b0: torch.Tensor) -> int:
    t1 = packed.shape[-1]
    if t1 not in CONFIGS or tuple(packed.shape) != (CONFIGS[t1][1], t1):
        raise ValueError(f"packed must be [W, T1] for (T1, W) in {[(t, c[1]) for t, c in CONFIGS.items()]}")
    if packed.dtype != torch.int32 or b0.dtype != torch.int32:
        raise ValueError("packed and b0 must be int32")
    return t1


def columns_chain(variant: str, packed: torch.Tensor, b0: torch.Tensor, loops: int) -> torch.Tensor:
    """The chain by ``variant`` ('cuda_cores' or 'tensor_cores') on CUDA
    tensors (``b0`` 1-D, a multiple of 1024 elements), the plain version on
    CPU tensors."""
    if variant not in _VARIANT:
        raise ValueError(f"unknown variant {variant!r}; expected one of {VARIANTS}")
    t1 = _check(packed, b0)
    if b0.device.type == "cpu":
        return columns_chain_plain(packed, b0, loops)
    if b0.dim() != 1 or b0.numel() % _BLOCK_ELEMENTS:
        raise ValueError(f"b0 must be 1-D with a multiple of {_BLOCK_ELEMENTS} elements")
    packed, b0 = packed.contiguous(), b0.contiguous()
    out = torch.empty_like(b0)
    with torch.cuda.device(b0.device):
        stream = torch.cuda.current_stream(b0.device).cuda_stream
        _library().launch(
            "lut_columns_chain", _VARIANT[variant], t1, packed.data_ptr(), b0.data_ptr(),
            out.data_ptr(), b0.numel(), loops, stream,
        )
    launches[variant_name(variant, t1)] += 1
    return out


def elements_to_fill(variant: str, t1: int, device: torch.device | str) -> int:
    """Elements of a launch that fills every SM of the CUDA ``device``,
    rounded up to a multiple of 1024."""
    n = ctypes.c_int(0)
    with torch.cuda.device(torch.device(device)):
        _library().launch("lut_columns_elements_to_fill", _VARIANT[variant], t1, ctypes.byref(n))
    return -(-n.value // _BLOCK_ELEMENTS) * _BLOCK_ELEMENTS


def mma_flops_per_step(t1: int) -> int:
    """Tensor-core flops per element-step of ``tensor_cores``: one-hot
    [1, T1] times [T1, 4W padded to a multiple of 8], 2 flops a product."""
    w = CONFIGS[t1][1]
    return 2 * t1 * (-(-4 * w // 8) * 8)


@functools.cache
def _library():
    """P1's library, built at first use."""
    from ._build import CLibrary

    p, i = ctypes.c_void_p, ctypes.c_int
    lib = CLibrary("lut_columns", {
        "lut_columns_chain": [i, i, p, p, p, i, i, p],
        "lut_columns_elements_to_fill": [i, i, ctypes.POINTER(i)],
        "lut_columns_block_elements": [i],
    })
    for name, v in _VARIANT.items():
        if _BLOCK_ELEMENTS % lib.value("lut_columns_block_elements", v):
            raise RuntimeError(f"csrc/lut_columns.cu's {name} block does not divide {_BLOCK_ELEMENTS}")
    return lib
