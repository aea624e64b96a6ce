"""The decoder config's home under its earlier name: :class:`DecoderConfig`
(``build_decoder_config``'s result, saved to and loaded from the
version-tagged ``.npz`` files that either package writes) lives in
``construct/awgn_dde.py``, the port's copy of the JAX package's module."""

from .awgn_dde import DecoderConfig

__all__ = ["DecoderConfig"]
