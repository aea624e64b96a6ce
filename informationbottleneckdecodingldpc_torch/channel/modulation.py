"""Modulation mappings and transmitters: BPSK, square QAM and M-PSK.

Port of ``channel/modulation.py``. The bit -> symbol maps are plain functions
on ``[n_bits, batch]`` tensors; the transmitters compose them with random
bits from a ``torch.Generator`` and, for :class:`LDPCTransmitter`, the
device encoder (``encode/encoder.py`` ``device_encoder``).

- QAM: consecutive groups of ``2 log2(sqrt_M)`` bits per symbol, the first
  half the real PAM level and the second half the imaginary one, MSB first;
  an ``encoding_table`` (rows of bit patterns in amplitude order, Gray by
  default) assigns the levels ``-sqrt_M+1 .. sqrt_M-1`` in steps of 2,
  scaled by ``d_min/2 = sqrt(6/(sqrt_M^2-1))/2`` (unit mean energy).
- M-PSK: groups of ``log2(M)`` bits, MSB first, mapped through the encoding
  table to the phases ``exp(2j pi k/M)``.

Symbols are float32 I/Q pairs ``[n_symbols, batch, 2]``, as in the JAX
package; :func:`iq_to_complex` converts them on the host. The float32
rounding points are the JAX package's: ``qam_map`` multiplies the float32
amplitude by the float32 ``d_min/2`` after the table lookup.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def bpsk_map(bits: torch.Tensor) -> torch.Tensor:
    """Map bits to float32 BPSK symbols: 0 -> +1, 1 -> -1."""
    return 1.0 - 2.0 * bits.to(torch.float32)


def gray_encoding_table(num_bits: int) -> np.ndarray:
    """[2**num_bits, num_bits] int8 bit patterns in Gray-code order: row k is
    the pattern of the k-th amplitude or phase."""
    n = 1 << num_bits
    codes = np.arange(n) ^ (np.arange(n) >> 1)
    return ((codes[:, None] >> np.arange(num_bits - 1, -1, -1)) & 1).astype(np.int8)


def _natural_values(encoding_table: np.ndarray) -> np.ndarray:
    """MSB-first integer value of each table row."""
    table = np.asarray(encoding_table)
    k = table.shape[1]
    return (table * (1 << np.arange(k - 1, -1, -1))).sum(1).astype(np.int64)


def qam_tables(encoding_table: np.ndarray, sqrt_m: int) -> tuple[np.ndarray, float]:
    """(amplitude of each pattern value [sqrt_m], d_min)."""
    amplitudes = np.zeros(sqrt_m)
    amplitudes[_natural_values(encoding_table)] = np.arange(-sqrt_m + 1, sqrt_m, 2)
    d_min = float(np.sqrt(6.0 / (sqrt_m**2 - 1)))
    return amplitudes, d_min


def mpsk_tables(encoding_table: np.ndarray, m: int) -> np.ndarray:
    """Complex unit symbol of each pattern value [m]."""
    phases = np.zeros(m, dtype=np.complex128)
    phases[_natural_values(encoding_table)] = np.exp(2j * np.pi / m * np.arange(m))
    return phases


def _msb_weights(k: int, device: torch.device | str) -> torch.Tensor:
    """[k] int32 weights 2^(k-1) .. 1, made on ``device`` (no host copy)."""
    return 1 << torch.arange(k - 1, -1, -1, dtype=torch.int32, device=device)


def _bit_masks(num_bits: int, device: torch.device | str) -> torch.Tensor:
    """[num_bits, 2**num_bits] bool on ``device``: row p is MSB-first bit p
    of each pattern value (the demapper's masks)."""
    v = torch.arange(1 << num_bits, dtype=torch.int32, device=device)
    return (v[None, :] & _msb_weights(num_bits, device)[:, None]) != 0


def _bit_group_values(bits: torch.Tensor, k: int,
                      weights: torch.Tensor | None = None) -> torch.Tensor:
    """[n, batch] bits -> [n // k, batch] int32 MSB-first values of
    consecutive groups of ``k`` bits along each codeword (``weights``:
    :func:`_msb_weights`, made here if not given)."""
    n, batch = bits.shape
    if n % k:
        raise ValueError(f"bit length {n} not divisible by group size {k}")
    if weights is None:
        weights = _msb_weights(k, bits.device)
    groups = bits.to(torch.int32).view(n // k, k, batch)
    return (groups * weights[None, :, None]).sum(1, dtype=torch.int32)


@dataclasses.dataclass(frozen=True)
class Constellation:
    """A QAM or M-PSK constellation's tables on one device, built once, so
    that a Monte-Carlo step makes no host-to-card copy (such a copy waits for
    the card's queue). ``order`` is sqrt(M) for QAM, M for M-PSK.

    - ``points``: indexed by pattern value, QAM's float32 amplitudes
      [sqrt_m] of one PAM axis (the map multiplies by ``scale``, the float32
      ``d_min/2``, after the lookup) or M-PSK's float32 I/Q points [m, 2];
    - ``levels``: the demapper's candidates, QAM's float32(amplitudes *
      d_min/2) from float64 [sqrt_m] (which may differ from the mapped
      symbols in the last bit, as in the JAX package) or M-PSK's points;
    - ``weights``: the map's MSB-first bit weights [bits_per_symbol];
    - ``masks``: the demapper's bit masks (:func:`_bit_masks`) of one PAM
      axis (QAM) or of a symbol (M-PSK).
    """

    modulation: str
    order: int
    points: torch.Tensor
    levels: torch.Tensor
    scale: float
    weights: torch.Tensor
    masks: torch.Tensor

    @classmethod
    def build(cls, modulation: str, order: int, encoding_table: np.ndarray,
              device: torch.device | str) -> "Constellation":
        bits = int(np.log2(order))
        if modulation == "qam":
            amplitudes, d_min = qam_tables(encoding_table, order)
            return cls(modulation, order,
                       torch.as_tensor(amplitudes, dtype=torch.float32, device=device),
                       torch.as_tensor(amplitudes * (d_min / 2.0), dtype=torch.float32,
                                       device=device),
                       float(np.float32(d_min / 2.0)),
                       _msb_weights(2 * bits, device), _bit_masks(bits, device))
        if modulation == "mpsk":
            phases = mpsk_tables(encoding_table, order)
            pts = torch.as_tensor(np.stack([phases.real, phases.imag], axis=-1),
                                  dtype=torch.float32, device=device)
            return cls(modulation, order, pts, pts, 1.0, _msb_weights(bits, device),
                       _bit_masks(bits, device))
        raise ValueError(f"unknown modulation {modulation!r}")

    @property
    def bits_per_symbol(self) -> int:
        bits = int(np.log2(self.order))
        return 2 * bits if self.modulation == "qam" else bits

    def map(self, bits: torch.Tensor) -> torch.Tensor:
        """[n, batch] bits -> [n / bits_per_symbol, batch, 2] float32 I/Q."""
        vals = _bit_group_values(bits, self.bits_per_symbol, self.weights).long()
        if self.modulation == "mpsk":
            return self.points[vals]
        k_half = self.bits_per_symbol // 2
        iq = torch.stack([self.points[vals >> k_half], self.points[vals & (self.order - 1)]],
                         dim=-1)
        return iq * self.scale


def qam_map(bits: torch.Tensor, encoding_table: np.ndarray, sqrt_m: int) -> torch.Tensor:
    """Map [n, batch] bits to [n / (2 log2 sqrt_m), batch, 2] float32 I/Q
    QAM symbols."""
    return Constellation.build("qam", sqrt_m, encoding_table, bits.device).map(bits)


def mpsk_map(bits: torch.Tensor, encoding_table: np.ndarray, m: int) -> torch.Tensor:
    """Map [n, batch] bits to [n / log2(m), batch, 2] float32 I/Q unit-energy
    M-PSK symbols."""
    return Constellation.build("mpsk", m, encoding_table, bits.device).map(bits)


def iq_to_complex(x: torch.Tensor) -> np.ndarray:
    """Host view of an I/Q pair tensor (last axis of 2) as complex."""
    arr = x.detach().cpu().numpy()
    return arr[..., 0] + 1j * arr[..., 1]


# ---------------------------------------------------------------------------
# Transmitters


@dataclasses.dataclass
class Transmitter:
    """Uncoded random-bit transmitter. ``modulation`` is 'bpsk', 'qam' or
    'mpsk'; for QAM and M-PSK ``order`` is sqrt(M) or M and the
    ``encoding_table`` defaults to Gray."""

    sequence_len: int
    modulation: str = "bpsk"
    order: int = 2
    encoding_table: np.ndarray | None = None

    def __post_init__(self):
        if self.modulation not in ("bpsk", "qam", "mpsk"):
            raise ValueError(self.modulation)
        if self.modulation != "bpsk" and self.encoding_table is None:
            self.encoding_table = gray_encoding_table(int(np.log2(self.order)))

    def map_bits(self, bits: torch.Tensor) -> torch.Tensor:
        if self.modulation == "bpsk":
            return bpsk_map(bits)
        if self.modulation == "qam":
            return qam_map(bits, self.encoding_table, self.order)
        return mpsk_map(bits, self.encoding_table, self.order)

    def transmit(self, generator: torch.Generator, batch: int,
                 device: torch.device | str | None = None):
        """(symbols, bits): uniform random int8 bits [sequence_len, batch]
        drawn from ``generator`` on ``device`` (the generator's by default)
        and their symbols."""
        device = generator.device if device is None else torch.device(device)
        bits = torch.randint(0, 2, (self.sequence_len, batch), generator=generator,
                             device=device, dtype=torch.int8)
        return self.map_bits(bits), bits


@dataclasses.dataclass
class LDPCTransmitter:
    """Encoded transmitter: random info bits -> GF(2) encode on the device ->
    modulate. ``encoder`` is an ``encode.LDPCEncoder``."""

    encoder: object
    modulation: str = "bpsk"
    order: int = 2
    encoding_table: np.ndarray | None = None

    def __post_init__(self):
        self._mapper = Transmitter(sequence_len=0, modulation=self.modulation,
                                   order=self.order, encoding_table=self.encoding_table)
        self._encoders: dict[torch.device, object] = {}

    def transmit(self, generator: torch.Generator, batch: int,
                 device: torch.device | str | None = None):
        """(symbols, info_bits, codeword_bits) of ``batch`` codewords whose
        info bits are drawn from ``generator`` on ``device``."""
        from ..encode.encoder import device_encoder

        device = generator.device if device is None else torch.device(device)
        if device not in self._encoders:
            self._encoders[device] = device_encoder(self.encoder, device)
        info = torch.randint(0, 2, (self.encoder.k, batch), generator=generator,
                             device=device, dtype=torch.int8)
        codeword = self._encoders[device](info)
        return self._mapper.map_bits(codeword), info, codeword
