"""Counter-based random planes of the Monte-Carlo engine, one column per codeword.

The JAX engine keys every codeword by ``fold_in(step_key, global codeword
index)`` and splits that key three ways (info bits, noise, the uniform plane
of inversion sampling; ``sim/engine.py:364-391``), so codeword i of step s
is the same codeword at any batch size and under any split of the batch.
The port keeps that property with Philox4x32-10 (Salmon et al., SC'11; the
generator of torch's own CUDA random numbers), not JAX's threefry bits:

- key: the 64-bit step seed (``engine.step_seed``), as two 32-bit words
  (:func:`key_words`);
- counter: (global codeword index, index of the 4-word group within the
  codeword's column, stream id, 0), with the stream ids of JAX's split order
  (:data:`STREAMS`).

Each 4-word group gives a column 4 uniforms (the top 24 bits of a word,
in [0, 1)), 2 normals (Box-Muller from two uniforms, the first shifted into
(0, 1] so that ``log`` never sees 0, ``sqrt(-2 log u1) cos(2 pi u2)``) or
128 bits (bit b of word w is element 32 w + b). A column is therefore a
pure function of (seed, round(ebn0_db * 1000), step, global codeword index).

:func:`plane_plain` computes a plane with torch int64 operations (a 32-bit
multiply-high through a wrapping int64 product, an arithmetic shift and a
mask), the same bits on the CPU and on a card; :func:`draw` gives a plane:
the plain version for the CPU, the kernel ``csrc/philox_planes.cu``
(``kernels/philox_planes.py``) for a CUDA device, which computes the same
planes, the normals through the same libdevice ``logf``, ``sqrtf`` and
``cosf`` that torch's CUDA operators call.

:func:`channel_input` is what the engine calls once per step: the decoder's
input of one fused kind (``philox_planes.FUSED``), the drawn plane run
through the quantizer and AWGN operators (:func:`consume`). Its plain
version :func:`channel_input_plain` is that composition on
:func:`plane_plain`; on a CUDA device the kernel computes it in one pass,
equal to the composition on the card.
"""

from __future__ import annotations

import math

import torch

from ..channel.awgn import received_plane
from ..channel.quantizer import (
    DeviceQuantizerTables,
    quantize_llr_with,
    quantize_with,
    sample_clusters_from_uniform,
    sample_llrs_from_uniform,
)
from ..kernels import philox_planes
from ..kernels.philox_planes import ELEMENTS_PER_GROUP, FUSED, STREAMS

MASK32 = 0xFFFFFFFF
PHILOX_M = (0xD2511F53, 0xCD9E8D57)  # round multipliers
PHILOX_W = (0x9E3779B9, 0xBB67AE85)  # key increments (Weyl sequence)
PHILOX_ROUNDS = 10
TWO_PI = 2.0 * math.pi
U24 = 2.0**-24  # one step of a 24-bit uniform


def key_words(seed64: int) -> tuple[int, int]:
    """A 64-bit seed as the Philox key (low word, high word)."""
    if not 0 <= seed64 < 2**64:
        raise ValueError(f"the key is a 64-bit unsigned value, got {seed64}")
    return seed64 & MASK32, seed64 >> 32


def mulhilo32(a: torch.Tensor, m: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of ``a * m`` for int64 ``a`` in [0, 2^32)
    and a 32-bit constant ``m``: the int64 product wraps to the low 64 bits
    of the full product, whose bits 32-63 the arithmetic shift and mask
    keep."""
    p = a * m
    return (p >> 32) & MASK32, p & MASK32


def philox4x32(counter, key: tuple[int, int]) -> tuple[torch.Tensor, ...]:
    """Philox4x32-10 of the four counter words (int64 tensors or ints in
    [0, 2^32), broadcast together) under ``key``: four int64 words."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) for c in counter)
    k0, k1 = key
    for r in range(PHILOX_ROUNDS):
        if r:
            k0, k1 = (k0 + PHILOX_W[0]) & MASK32, (k1 + PHILOX_W[1]) & MASK32
        hi0, lo0 = mulhilo32(c0, PHILOX_M[0])
        hi1, lo1 = mulhilo32(c2, PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def groups(kind: str, rows: int) -> int:
    """4-word groups of a column of ``rows`` elements of ``kind``."""
    return -(-rows // ELEMENTS_PER_GROUP[kind])


def check_plane(kind: str, rows: int, offset: int, batch: int) -> None:
    """Refuse a plane the counter layout does not hold: codeword indices
    [offset, offset + batch) must fit the first 32-bit counter word."""
    if kind not in STREAMS:
        raise ValueError(f"unknown plane kind {kind!r}; expected one of {tuple(STREAMS)}")
    if rows < 1 or batch < 1 or offset < 0 or offset + batch > 2**32:
        raise ValueError(
            f"a plane takes rows, batch >= 1 and codewords below 2^32, got rows {rows}, "
            f"codewords [{offset}, {offset + batch})"
        )


def check_kind(kind: str) -> None:
    """Refuse a channel input that is not one of the fused kinds."""
    if kind not in FUSED:
        raise ValueError(f"unknown channel input {kind!r}; expected one of {tuple(FUSED)}")


def uniform24(word: torch.Tensor) -> torch.Tensor:
    """float32 uniform in [0, 1) from the top 24 bits of a word (exact)."""
    return (word >> 8).to(torch.float32) * U24


def plane_plain(
    kind: str, key: tuple[int, int], rows: int, offset: int, batch: int,
    device: torch.device | str = "cpu",
) -> torch.Tensor:
    """The [rows, batch] plane of ``kind`` ('uniform' and 'normal' float32,
    'bits' int8) of codewords [offset, offset + batch) under ``key``."""
    check_plane(kind, rows, offset, batch)
    device = torch.device(device)
    g = torch.arange(groups(kind, rows), dtype=torch.int64, device=device)[:, None]
    idx = torch.arange(offset, offset + batch, dtype=torch.int64, device=device)[None, :]
    w = torch.stack(philox4x32((idx, g, STREAMS[kind], 0), key), dim=1)  # [G, 4, batch]
    if kind == "uniform":
        out = uniform24(w)
    elif kind == "normal":
        u1 = ((w[:, 0::2] >> 8) + 1).to(torch.float32) * U24  # (0, 1]
        u2 = uniform24(w[:, 1::2])
        out = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(TWO_PI * u2)  # [G, 2, batch]
    else:
        shifts = torch.arange(32, dtype=torch.int64, device=device)[None, None, :, None]
        out = ((w[:, :, None, :] >> shifts) & 1).to(torch.int8)  # [G, 4, 32, batch]
    return out.reshape(-1, batch)[:rows]


def draw(
    kind: str, key: tuple[int, int], rows: int, offset: int, batch: int,
    device: torch.device | str,
) -> torch.Tensor:
    """The plane of :func:`plane_plain` on ``device``: computed there by the
    plain version on the CPU and by the Philox kernel on a CUDA device
    (which launches it or raises)."""
    device = torch.device(device)
    if device.type == "cpu":
        return plane_plain(kind, key, rows, offset, batch, device)
    check_plane(kind, rows, offset, batch)
    return philox_planes.plane(kind, key, rows, offset, batch, device)


def consume(
    kind: str, plane: torch.Tensor, tables: DeviceQuantizerTables, sigma2: float | None = None,
    codeword: torch.Tensor | None = None,
) -> torch.Tensor:
    """The decoder's input of fused ``kind`` from its drawn ``plane`` by the
    quantizer and AWGN operators: inversion sampling of the all-zeros
    codeword from a uniform plane (clusters, or their LLRs); y =
    bpsk(codeword) + sqrt(sigma^2) n from a normal plane (the all-zeros
    codeword when ``codeword`` is None), then its cluster, the cluster's LLR
    or 2y / sigma^2."""
    draw, consumer, encoded = FUSED[kind]
    if encoded != (codeword is not None):
        raise ValueError(f"{kind} {'reads' if encoded else 'takes no'} codeword")
    if draw == "uniform":
        zeros = torch.zeros(plane.shape, dtype=torch.int32, device=plane.device)
        if consumer == "clusters":
            return sample_clusters_from_uniform(tables.cdf, plane, zeros)
        return sample_llrs_from_uniform(tables.cdf, tables.llrs, plane, zeros)
    if codeword is None:
        codeword = torch.zeros(plane.shape, dtype=torch.int8, device=plane.device)
    return from_received(consumer, received_plane(codeword, plane, sigma2), tables, sigma2)


def from_received(
    consumer: str, y: torch.Tensor, tables: DeviceQuantizerTables, sigma2: float | None = None
) -> torch.Tensor:
    """What the decoder reads of the received plane ``y``: its cluster
    ('clusters'), that cluster's LLR ('llrs') or 2y / sigma^2 ('true')."""
    if consumer == "clusters":
        return quantize_with(tables.limits, y)
    if consumer == "llrs":
        return quantize_llr_with(tables.limits, tables.llrs, y)
    return 2.0 * y / sigma2


def channel_input_plain(
    kind: str, key: tuple[int, int], rows: int, offset: int, batch: int,
    tables: DeviceQuantizerTables, sigma2: float | None = None,
    codeword: torch.Tensor | None = None, device: torch.device | str = "cpu",
) -> torch.Tensor:
    """The decoder's [rows, batch] input of fused ``kind`` for codewords
    [offset, offset + batch) under ``key``: :func:`consume` of the plane
    :func:`plane_plain` draws."""
    check_kind(kind)
    plane = plane_plain(philox_planes.draw_of(kind), key, rows, offset, batch, device)
    return consume(kind, plane, tables, sigma2, codeword)


def channel_input(
    kind: str, key: tuple[int, int], rows: int, offset: int, batch: int,
    device: torch.device | str, tables: DeviceQuantizerTables,
    sigma2: float | None = None, codeword: torch.Tensor | None = None,
) -> torch.Tensor:
    """The input of :func:`channel_input_plain` on ``device``: computed there
    by the plain version on the CPU and by the kernel, in one launch, on a
    CUDA device (which launches it or raises)."""
    device = torch.device(device)
    if device.type == "cpu":
        return channel_input_plain(kind, key, rows, offset, batch, tables, sigma2, codeword, device)
    check_kind(kind)
    check_plane(philox_planes.draw_of(kind), rows, offset, batch)
    return philox_planes.channel_input(kind, key, rows, offset, batch, device, tables, sigma2,
                                       codeword)

