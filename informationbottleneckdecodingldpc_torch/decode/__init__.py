"""Decode layout, result type, and the plain IB, min-sum and BP decoders."""

from .bp import belief_propagation_decode
from .common import (
    DecodeResult,
    apply_per_cn_group,
    apply_per_vn_group,
    gather_node_values_per_group,
    group_planes,
    node_outputs_to_natural_order,
    run_message_passing_loop,
    unsatisfied_checks,
)
from .float_common import float_decode
from .graph_arrays import DecodeLayout, GroupSpec, LayoutTensors
from .ib_lut import DeviceTrellis, ib_lut_decode
from .min_sum import min_sum_decode

__all__ = [
    "DecodeLayout",
    "DecodeResult",
    "DeviceTrellis",
    "GroupSpec",
    "LayoutTensors",
    "apply_per_cn_group",
    "apply_per_vn_group",
    "belief_propagation_decode",
    "float_decode",
    "gather_node_values_per_group",
    "group_planes",
    "ib_lut_decode",
    "min_sum_decode",
    "node_outputs_to_natural_order",
    "run_message_passing_loop",
    "unsatisfied_checks",
]
