"""Soft demappers: exact per-bit LLRs of QAM and M-PSK AWGN observations.

Port of ``channel/demap.py``: exact (log-sum-exp) bit LLRs that the float
decoders (min-sum, BP) read, so the M-ary chains need no new decoder
construction. Conventions, as in ``channel.modulation``:

- symbols are float32 I/Q pairs ``[n_sym, batch, 2]`` with unit mean energy;
- ``n0`` is the complex-noise variance E|n|^2 (n0/2 per component);
- a symbol carries ``k`` bits MSB first; square QAM splits them as
  [real k/2 | imag k/2];
- a positive LLR favours bit 0, as the BPSK ``2y/sigma^2`` does.

The operations follow the JAX package's order, so that the two agree to a
few float32 ULPs (``exp`` and ``log`` differ in their last bits between XLA
and torch): QAM multiplies its squared distances by the float32 reciprocal
of ``n0``, M-PSK divides them by ``n0``, and each log-sum-exp subtracts its
maximum first, as ``jax.scipy.special.logsumexp`` does. On a CUDA tensor
these run as torch operators on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from .modulation import Constellation


def n0_from_sigma2(sigma2, bits_per_symbol: int):
    """Complex-noise variance N0 for the engine's BPSK-convention sigma^2:
    N0 = 2 sigma^2 for one coded bit per unit-energy symbol, so
    N0 = 2 sigma^2 / k at ``bits_per_symbol`` coded bits per symbol."""
    return 2.0 * sigma2 / bits_per_symbol


def _logsumexp(x: torch.Tensor) -> torch.Tensor:
    """log sum exp over the last axis, the maximum subtracted first (0 where
    it is not finite)."""
    m = x.amax(dim=-1, keepdim=True)
    m = m.masked_fill(~torch.isfinite(m), 0.0)
    return torch.log(torch.exp(x - m).sum(dim=-1)) + m[..., 0]


def _llrs_from_metrics(metrics: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """metrics [..., V] (log domain, per candidate pattern) -> [..., num_bits]
    exact LLRs: log sum_{v: bit=0} e^m - log sum_{v: bit=1} e^m, each sum a
    log-sum-exp over V with -inf where the mask excludes; every bit at once
    (the metrics broadcast against the [num_bits, V] bool ``masks``,
    ``Constellation.masks``)."""
    m = metrics[..., None, :]
    llr0 = _logsumexp(torch.where(masks, -torch.inf, m))
    llr1 = _logsumexp(torch.where(masks, m, -torch.inf))
    return llr0 - llr1


def _interleave_to_bits(llr_sym: torch.Tensor) -> torch.Tensor:
    """[n_sym, batch, k] per-symbol bit LLRs -> contiguous [n_sym * k, batch]
    in codeword order (the k bits of a symbol consecutive), as the decoders
    read them."""
    n_sym, batch, k = llr_sym.shape
    return llr_sym.permute(0, 2, 1).reshape(n_sym * k, batch).contiguous()


def demap_llrs(constellation: Constellation, y_iq: torch.Tensor, n0: float) -> torch.Tensor:
    """Exact bit LLRs of ``constellation``'s observations: [n_sym, batch, 2]
    -> [n, batch]. For square QAM the real component depends only on the
    first k/2 bits and the imaginary on the last k/2, so each is an
    independent sqrt_M-ary PAM demap with per-component noise variance n0/2."""
    if constellation.modulation == "qam":
        k_half = constellation.bits_per_symbol // 2
        inv = float(np.float32(1.0 / float(n0)))  # 1/(2 (n0/2)): -(y-a)^2 / (2 var)
        d = y_iq[..., None] - constellation.levels  # [n_sym, batch, 2 (I, Q), sqrt_m]
        llr = _llrs_from_metrics(-(d * d) * inv, constellation.masks)  # [n_sym, batch, 2, k_half]
        n_sym, batch = y_iq.shape[:2]
        return _interleave_to_bits(llr.reshape(n_sym, batch, 2 * k_half))
    d = y_iq[..., None, :] - constellation.levels  # [n_sym, batch, m, 2]
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
    # A divisor on the data's device (filled there): torch's CUDA division by
    # a host scalar multiplies by its reciprocal instead.
    n0_t = torch.full((), float(np.float32(n0)), dtype=torch.float32, device=y_iq.device)
    return _interleave_to_bits(_llrs_from_metrics(-d2 / n0_t, constellation.masks))


def qam_bit_llrs(y_iq: torch.Tensor, encoding_table: np.ndarray, sqrt_m: int,
                 n0: float) -> torch.Tensor:
    """Exact bit LLRs of square-QAM observations: [n_sym, batch, 2] ->
    [n, batch] (:func:`demap_llrs`)."""
    return demap_llrs(Constellation.build("qam", sqrt_m, encoding_table, y_iq.device), y_iq, n0)


def mpsk_bit_llrs(y_iq: torch.Tensor, encoding_table: np.ndarray, m: int,
                  n0: float) -> torch.Tensor:
    """Exact bit LLRs of M-PSK observations: [n_sym, batch, 2] -> [n, batch]
    (:func:`demap_llrs`)."""
    return demap_llrs(Constellation.build("mpsk", m, encoding_table, y_iq.device), y_iq, n0)
