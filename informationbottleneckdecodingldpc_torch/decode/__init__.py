"""Decode layout, result type and the plain IB lookup-table decoder."""

from .common import DecodeResult, run_message_passing_loop, unsatisfied_checks
from .graph_arrays import DecodeLayout, GroupSpec, LayoutTensors
from .ib_lut import DeviceTrellis, ib_lut_decode

__all__ = [
    "DecodeLayout",
    "DecodeResult",
    "DeviceTrellis",
    "GroupSpec",
    "LayoutTensors",
    "ib_lut_decode",
    "run_message_passing_loop",
    "unsatisfied_checks",
]
