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
``cuda_cores`` (shared-memory loads of the table :func:`cuda_table` lays
out) and ``tensor_cores`` (a one-hot u8 ``mma`` against the packed words'
bytes, :func:`byte_matrix`, passed as :func:`b_fragments`). Both operands
are built here, with torch on the tensor's device. For a CUDA tensor
:func:`columns_chain` launches the kernel of ``variant`` and counts the
launch in :data:`launches`; for a CPU tensor it runs
:func:`columns_chain_plain`, which computes the chain by indexing. There is
no fallback from one to the other.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import weakref

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


# Columns of the tensor-core kernel's byte matrix: n-tiles of 8 columns per
# T1, and per column the (word, byte) of the packed column it holds. An
# n-tile of words 2 nt and 2 nt + 1 puts in columns 2p and 2p + 1 (the two
# columns lane q = p of a group holds) bytes 2 (p >> 1) and 2 (p >> 1) + 1 of
# word 2 nt + (p & 1), so that the kernel's two exchanges leave each lane
# whole words. T1 = 32's word 4 fills its own n-tile twice, bytes 0-3 then
# 0-3 again, so that a lane and its neighbour (lane ^ 1) hold it together.
N_TILES = {16: 1, 32: 3}


def _column_bytes(t1: int) -> list[tuple[int, int]]:
    w = CONFIGS[t1][1]
    out = []
    for nt in range(w // 2):
        out += [(2 * nt + (c >> 1 & 1), 2 * (c >> 2) + (c & 1)) for c in range(8)]
    if w % 2:
        out += [(w - 1, c & 3) for c in range(8)]
    assert len(out) == 8 * N_TILES[t1]
    return out


COLUMN_BYTES = {t1: _column_bytes(t1) for t1 in CONFIGS}
COPIES = 8  # the T1 = 32 CUDA-core table's copies of its nibble words, one per bank group
# Shared-memory loads of a CUDA-core step: W words at T1 = 16; the four
# nibble words in one 128-bit load and the high-bit word at T1 = 32.
CUDA_LOADS_PER_STEP = {16: 2, 32: 2}


def byte_matrix(packed: torch.Tensor) -> torch.Tensor:
    """The tensor-core kernel's B operand [T1, 8 NT] (int64 bytes): row k is
    column k of the packed LUT, its bytes in :data:`COLUMN_BYTES` order."""
    t1 = packed.shape[-1]
    word, byte = (torch.tensor(v, device=packed.device) for v in zip(*COLUMN_BYTES[t1]))
    words = packed.long() & 0xFFFFFFFF
    return ((words[word] >> (8 * byte)[:, None]) & 255).T


def b_fragments(packed: torch.Tensor) -> torch.Tensor:
    """The byte matrix as the mma's B fragments, lane-major int32 [NT, T1 /
    16, 32]: register r of n-tile nt of lane (g, q) = lane // 4, lane % 4
    holds rows 16 r + 4 q + i (byte i) of column 8 nt + g (the PTX ISA's
    m16n8k16 and m16n8k32 u8 B layouts)."""
    mat = byte_matrix(packed)
    t1, dev = mat.shape[0], packed.device
    lane = torch.arange(32, device=dev)
    nt = torch.arange(N_TILES[t1], device=dev)[:, None, None, None]
    r = torch.arange(t1 // 16, device=dev)[None, :, None, None]
    i = torch.arange(4, device=dev)
    k = 16 * r + 4 * (lane & 3)[:, None] + i
    n = 8 * nt + (lane >> 2)[:, None]
    return wrap_int32((mat[k, n] << (8 * i)).sum(-1))


def cuda_table(packed: torch.Tensor) -> torch.Tensor:
    """The CUDA-core kernel's shared-memory table, int32: at T1 = 16 the
    packed LUT as it is, [W][T1]; at T1 = 32 :data:`COPIES` copies of the
    nibble words as [copy][T1][4] interleaved by column (column b of copy c
    at words 4 (8 b + c) ... + 3, in bank group c) and then the high-bit
    words [T1]."""
    t1 = packed.shape[-1]
    if t1 == 16:
        return packed.reshape(-1)
    nibbles = packed[:-1].T[:, None, :].expand(t1, COPIES, 4)
    return torch.cat([nibbles.reshape(-1), packed[-1]])


def operand(variant: str, packed: torch.Tensor) -> torch.Tensor:
    """The kernel's constant operand for ``variant``, contiguous int32."""
    build = cuda_table if variant == "cuda_cores" else b_fragments
    return build(packed).contiguous()


# variant -> (weak reference to the packed LUT, its version, its operand on
# the card): a chain's operand is built once while its LUT is unchanged, so
# a launch costs the launch alone.
_operands: dict = {}


def _operand_on(variant: str, packed: torch.Tensor, device: torch.device) -> torch.Tensor:
    ref, version, const = _operands.get(variant, (None, None, None))
    if ref is None or ref() is not packed or version != packed._version or const.device != device:
        const = operand(variant, packed.to(device))
        _operands[variant] = (weakref.ref(packed), packed._version, const)
    return const


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
    b0 = b0.contiguous()
    out = torch.empty_like(b0)
    with torch.cuda.device(b0.device):
        const = _operand_on(variant, packed, b0.device)
        stream = torch.cuda.current_stream(b0.device).cuda_stream
        _library().launch(
            "lut_columns_chain", _VARIANT[variant], t1, const.data_ptr(), b0.data_ptr(),
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


def block_elements(variant: str) -> int:
    """Elements of one block of ``variant``'s kernel (256 threads)."""
    return _library().value("lut_columns_block_elements", _VARIANT[variant])


def kernel_name(variant: str, t1: int) -> str:
    """The part of the mangled name of ``variant``'s kernel at ``t1`` that
    tells it from the others (``nvcc -Xptxas -v``, ``cuobjdump -sass``)."""
    fb, w = CONFIGS[t1]
    return f"{variant}_kernelILi{t1}ELi{fb}ELi{w}EE"


def mma_flops_per_step(t1: int) -> int:
    """Tensor-core int8 operations per element-step that a one-hot matmul
    building the column needs: one-hot [1, T1] times the column's 4W bytes
    [T1, 4W], 2 operations a product (the kernel's n-tiles pad 4W to 8
    NT)."""
    return 2 * t1 * 4 * CONFIGS[t1][1]


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
