"""Plain PyTorch building blocks of the message-passing loops."""

from .float_ops import (
    LLR_MAX,
    associative_leave_one_out,
    boxplus,
    cn_boxplus_leave_one_out,
    cn_minsum_leave_one_out,
    min_sum_op,
    minsum_leave_one_out_planes,
    sum_planes,
    vn_sum_leave_one_out,
)
from .lut_fold import (
    cn_lut_leave_one_out,
    vector_lookup,
    vn_lut_full_fold,
    vn_lut_leave_one_out,
)

__all__ = [
    "LLR_MAX",
    "associative_leave_one_out",
    "boxplus",
    "cn_boxplus_leave_one_out",
    "cn_lut_leave_one_out",
    "cn_minsum_leave_one_out",
    "min_sum_op",
    "minsum_leave_one_out_planes",
    "sum_planes",
    "vector_lookup",
    "vn_lut_full_fold",
    "vn_lut_leave_one_out",
    "vn_sum_leave_one_out",
]
