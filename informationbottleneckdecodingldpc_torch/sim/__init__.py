"""Monte-Carlo BER engine with Eb/N0 sweeps and resumable state."""

from .engine import BERSimulator, PointCheckpoint, PointResult
from .results import load_results, save_results
from .sweep import SweepController, SweepSchedule

__all__ = [
    "BERSimulator",
    "PointCheckpoint",
    "PointResult",
    "SweepController",
    "SweepSchedule",
    "load_results",
    "save_results",
]
