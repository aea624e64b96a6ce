"""AWGN channel (port of ``channel/awgn.py``): noise from a
``torch.Generator``, the Eb/N0 conventions, and the BPSK received plane."""

from __future__ import annotations

import math

import numpy as np
import torch

from .modulation import bpsk_map


def awgn_transmit(
    generator: torch.Generator, x: torch.Tensor, sigma2: float, complex_noise: bool = False
) -> torch.Tensor:
    """y = x + n with float32 Gaussian noise of variance ``sigma2`` drawn from
    ``generator`` (on ``x``'s device). Complex symbols are I/Q pairs (a
    trailing axis of 2): with ``complex_noise`` each component has variance
    sigma2 / 2."""
    scale = math.sqrt(sigma2 / 2.0 if complex_noise else sigma2)
    noise = torch.randn(x.shape, generator=generator, device=x.device, dtype=torch.float32)
    return x + scale * noise


def sigma2_from_ebn0_db(ebn0_db, code_rate: float):
    """sigma^2 = 10^(-EbN0/10) / (2 R_c), the BPSK convention of the
    reference simulations."""
    return 10.0 ** (-ebn0_db / 10.0) / (2.0 * code_rate)


def ebn0_db_from_sigma2(sigma2, code_rate: float):
    """Inverse of :func:`sigma2_from_ebn0_db`."""
    return -10.0 * np.log10(sigma2 * 2.0 * code_rate)


def received_plane(bits: torch.Tensor, noise: torch.Tensor, sigma2: float) -> torch.Tensor:
    """y = bpsk(bits) + sqrt(sigma^2) n in float32: a multiply, then an add
    (XLA on the CPU fuses them into one FMA, so the JAX value may differ in
    the last bit)."""
    return bpsk_map(bits) + math.sqrt(sigma2) * noise
