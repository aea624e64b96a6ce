"""Monte-Carlo BER engine."""

from .engine import BERSimulator, PointResult

__all__ = ["BERSimulator", "PointResult"]
