"""Batch bit packing: [rows, batch] 0/1 arrays <-> [rows, words] uint64.

Bit b of word w holds codeword (64*w + b)'s value; the batch axis is padded
to a multiple of 64.
"""

from __future__ import annotations

import numpy as np


def pack_bits(bits: np.ndarray) -> tuple[np.ndarray, int]:
    """Pack [rows, batch] into ([rows, words] uint64, original batch size)."""
    bits = np.asarray(bits)
    rows, batch = bits.shape
    words = (batch + 63) // 64
    padded = np.zeros((rows, words * 64), dtype=np.uint8)
    padded[:, :batch] = bits.astype(np.uint8) & 1
    # little-endian within each 64-bit word
    by = np.packbits(padded.reshape(rows, words, 8, 8)[:, :, :, ::-1], axis=-1)
    packed = np.ascontiguousarray(by.reshape(rows, words, 8)).view(np.uint64)
    return np.ascontiguousarray(packed.reshape(rows, words)), batch


def unpack_bits(packed: np.ndarray, batch: int) -> np.ndarray:
    """Inverse of :func:`pack_bits`."""
    rows, words = packed.shape
    as_bytes = packed.reshape(rows, words, 1).view(np.uint8)
    bits = np.unpackbits(as_bytes, axis=-1).reshape(rows, words, 8, 8)[:, :, :, ::-1]
    return bits.reshape(rows, words * 64)[:, :batch].astype(np.int8)
