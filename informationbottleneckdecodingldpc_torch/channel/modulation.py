"""BPSK mapping (port of ``channel/modulation.py`` ``bpsk_map``).

QAM, M-PSK and the Gray tables are not ported yet (ROADMAP item 1).
"""

from __future__ import annotations

import torch


def bpsk_map(bits: torch.Tensor) -> torch.Tensor:
    """Map bits to float32 BPSK symbols: 0 -> +1, 1 -> -1."""
    return 1.0 - 2.0 * bits.to(torch.float32)
