"""GF(2) encoding for the encoded BPSK chain: the JAX package's numpy host
encoder ``LDPCEncoder``, reused as it is, and the port's device path."""

from .encoder import LDPCEncoder, device_encoder

__all__ = ["LDPCEncoder", "device_encoder"]
