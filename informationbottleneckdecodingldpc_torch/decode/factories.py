"""Decoder factories that close over the layout and the tables.

Port of ``decode/jit.py``: the same three factories with the same
signatures, each returning a callable of the channel input that runs the
port's plain decoder (``ib_lut_decode``, ``min_sum_decode``,
``belief_propagation_decode``). Nothing is compiled: the JAX factories
trace once per shape under ``jax.jit``, while here the hand-written kernels
(``kernels``; the engine picks them) are the fast path, and these closures
run the plain decoders on whatever device their input and tables are on.
"""

from __future__ import annotations

from typing import Callable

import torch

from .bp import belief_propagation_decode
from .common import DecodeResult
from .graph_arrays import DecodeLayout
from .ib_lut import DeviceTrellis, ib_lut_decode
from .min_sum import min_sum_decode


def make_ib_lut_decoder(
    layout: DecodeLayout,
    trellis: DeviceTrellis,
    max_iters: int | None = None,
    early_exit: bool = True,
    convergence_reduce: Callable | None = None,
) -> Callable[[torch.Tensor], DecodeResult]:
    """fn: channel clusters [n_vars, batch] -> DecodeResult."""

    def decode(channel_clusters: torch.Tensor) -> DecodeResult:
        return ib_lut_decode(
            layout,
            trellis,
            channel_clusters,
            max_iters=max_iters,
            early_exit=early_exit,
            convergence_reduce=convergence_reduce,
        )

    return decode


def _make_float(decode_fn, layout, max_iters, early_exit, convergence_reduce):
    def decode(channel_llrs: torch.Tensor) -> DecodeResult:
        return decode_fn(
            layout,
            channel_llrs,
            max_iters=max_iters,
            early_exit=early_exit,
            convergence_reduce=convergence_reduce,
        )

    return decode


def make_min_sum_decoder(
    layout: DecodeLayout,
    max_iters: int,
    early_exit: bool = True,
    convergence_reduce: Callable | None = None,
) -> Callable[[torch.Tensor], DecodeResult]:
    """fn: channel LLRs [n_vars, batch] -> DecodeResult."""
    return _make_float(min_sum_decode, layout, max_iters, early_exit, convergence_reduce)


def make_bp_decoder(
    layout: DecodeLayout,
    max_iters: int,
    early_exit: bool = True,
    convergence_reduce: Callable | None = None,
) -> Callable[[torch.Tensor], DecodeResult]:
    """fn: channel LLRs [n_vars, batch] -> DecodeResult."""
    return _make_float(
        belief_propagation_decode, layout, max_iters, early_exit, convergence_reduce
    )
