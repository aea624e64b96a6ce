"""AWGN channel conventions (port of ``channel/awgn.py``)."""

from __future__ import annotations


def sigma2_from_ebn0_db(ebn0_db, code_rate: float):
    """sigma^2 = 10^(-EbN0/10) / (2 R_c), the BPSK convention of the
    reference simulations."""
    return 10.0 ** (-ebn0_db / 10.0) / (2.0 * code_rate)
