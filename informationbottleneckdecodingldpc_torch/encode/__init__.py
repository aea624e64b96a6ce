"""GF(2) encoding for the encoded BPSK chain: the host encoder
``LDPCEncoder`` (factorization and batched bit-packed substitution) and its
device path ``device_encoder``."""

from .encoder import LDPCEncoder, device_encoder
from .gf2 import gf2_factorize_packed, is_full_diag_triangular

__all__ = ["LDPCEncoder", "device_encoder", "gf2_factorize_packed", "is_full_diag_triangular"]
