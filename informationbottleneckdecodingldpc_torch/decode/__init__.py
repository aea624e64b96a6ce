"""Decode layout, result type, the plain IB, min-sum and BP decoders, and
factories that close over a layout and its tables."""

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
from .factories import make_bp_decoder, make_ib_lut_decoder, make_min_sum_decoder
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
    "make_bp_decoder",
    "make_ib_lut_decoder",
    "make_min_sum_decoder",
    "min_sum_decode",
    "node_outputs_to_natural_order",
    "run_message_passing_loop",
    "unsatisfied_checks",
]
