"""AWGN channel conventions (port of ``channel/awgn.py``) and the BPSK
received plane."""

from __future__ import annotations

import math

import torch

from .modulation import bpsk_map


def sigma2_from_ebn0_db(ebn0_db, code_rate: float):
    """sigma^2 = 10^(-EbN0/10) / (2 R_c), the BPSK convention of the
    reference simulations."""
    return 10.0 ** (-ebn0_db / 10.0) / (2.0 * code_rate)


def received_plane(bits: torch.Tensor, noise: torch.Tensor, sigma2: float) -> torch.Tensor:
    """y = bpsk(bits) + sqrt(sigma^2) n in float32: a multiply, then an add
    (XLA on the CPU fuses them into one FMA, so the JAX value may differ in
    the last bit)."""
    return bpsk_map(bits) + math.sqrt(sigma2) * noise
