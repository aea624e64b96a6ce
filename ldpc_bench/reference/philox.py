"""Counter-based random planes, one column per codeword: Philox4x32-10
(Salmon et al., SC'11) in plain torch int64 arithmetic.

A frozen copy of the draw arithmetic the system under test states for its
Monte-Carlo steps, kept here so that the yardstick does not move with the
program:

- the step key: ``numpy.random.SeedSequence([seed, round(ebn0_db * 1000)
  mod 2^32, step])`` gives two 32-bit words w0, w1; the key is the 64-bit
  value (w0 << 31) ^ w1, as a low and a high 32-bit word;
- the counter of a 4-word group: (global codeword index, group index within
  the codeword's column, stream, 0), the streams being info bits 0, noise 1,
  inversion uniforms 2;
- a group gives 4 uniforms (the top 24 bits of each word, times 2^-24), 2
  normals (Box-Muller: u1 = (w0 >> 8) + 1 over 2^24, in (0, 1], u2 from w1,
  sqrt(-2 log u1) cos(2 pi u2); the same for w2, w3), or 128 bits (bit b of
  word w is element 32 w + b).
"""

from __future__ import annotations

import math

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
ROUND_MULTIPLIERS = (0xD2511F53, 0xCD9E8D57)
KEY_INCREMENTS = (0x9E3779B9, 0xBB67AE85)
ROUNDS = 10
STREAMS = {"bits": 0, "normal": 1, "uniform": 2}
PER_GROUP = {"bits": 128, "normal": 2, "uniform": 4}
U24 = 2.0**-24


def step_key(seed: int, ebn0_db: float, step: int) -> tuple[int, int]:
    """The Philox key (low word, high word) of one Monte-Carlo step."""
    words = [seed, int(round(ebn0_db * 1000)) % 2**32, step]
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)
    key = (int(state[0]) << 31) ^ int(state[1])
    return key & MASK32, key >> 32


def philox4x32(counter, key: tuple[int, int]) -> tuple[torch.Tensor, ...]:
    """Philox4x32-10 of four counter words (int64 tensors or ints in
    [0, 2^32), broadcast together): four int64 words in [0, 2^32)."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) for c in counter)
    k0, k1 = key
    for r in range(ROUNDS):
        if r:
            k0 = (k0 + KEY_INCREMENTS[0]) & MASK32
            k1 = (k1 + KEY_INCREMENTS[1]) & MASK32
        p0 = c0 * ROUND_MULTIPLIERS[0]  # wraps to the low 64 bits of the product
        p1 = c2 * ROUND_MULTIPLIERS[1]
        hi0, lo0 = (p0 >> 32) & MASK32, p0 & MASK32
        hi1, lo1 = (p1 >> 32) & MASK32, p1 & MASK32
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def plane(kind: str, key: tuple[int, int], rows: int, offset: int, batch: int,
          device: torch.device | str) -> torch.Tensor:
    """The [rows, batch] plane of ``kind`` for codewords [offset, offset +
    batch): float32 for 'uniform' and 'normal', int8 for 'bits'."""
    device = torch.device(device)
    groups = -(-rows // PER_GROUP[kind])
    g = torch.arange(groups, dtype=torch.int64, device=device)[:, None]
    idx = torch.arange(offset, offset + batch, dtype=torch.int64, device=device)[None, :]
    w = torch.stack(philox4x32((idx, g, STREAMS[kind], 0), key), dim=1)  # [G, 4, batch]
    if kind == "uniform":
        out = (w >> 8).to(torch.float32) * U24
    elif kind == "normal":
        u1 = ((w[:, 0::2] >> 8) + 1).to(torch.float32) * U24
        u2 = (w[:, 1::2] >> 8).to(torch.float32) * U24
        out = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * math.pi * u2)
    else:
        shifts = torch.arange(32, dtype=torch.int64, device=device)[None, None, :, None]
        out = ((w[:, :, None, :] >> shifts) & 1).to(torch.int8)
    return out.reshape(-1, batch)[:rows]
