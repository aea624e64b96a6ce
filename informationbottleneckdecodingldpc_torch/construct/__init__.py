"""Trellis tables and loading of constructed decoder configs."""

from .config import DecoderConfig
from .trellis import TrellisTables

__all__ = ["DecoderConfig", "TrellisTables"]
