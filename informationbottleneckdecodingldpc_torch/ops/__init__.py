"""Plain PyTorch building blocks of the message-passing loops."""

from .lut_fold import (
    cn_lut_leave_one_out,
    vector_lookup,
    vn_lut_full_fold,
    vn_lut_leave_one_out,
)

__all__ = [
    "cn_lut_leave_one_out",
    "vector_lookup",
    "vn_lut_full_fold",
    "vn_lut_leave_one_out",
]
