"""Measured peak rates of the decoders' primitives, for the roofline.

Port of ``utils/peaks.py``. The JAX package measures its TPU primitives
(packed-column builds and field extracts, float op applications) with Pallas
microkernels; the port measures the primitives its Hopper decoders run, with
the CUDA microkernels K5a, K5b and K5c of ``kernels/peaks.py``:

- ``("lookup1d", T)``: 1-D byte-table lookups/s (the alignment remaps);
- ``("lookup2d", T)``: pairwise-LUT lookups/s through ``ib_lut::Luts`` (every
  step of a node fold), the tables shared by a block as K1 holds them;
- ``("lookup2d_lanes", T)``: the same with a copy of the tables per lane, so
  no two lanes of a warp meet in a shared-memory bank. The roofline takes
  the faster of the two as the pairwise-lookup peak (:func:`lookup2d_peak`);
- ``"minsum_op"``, ``"boxplus"``, ``"float_mix"`` (add + clip), ``"min"``:
  float op applications/s.

Each kernel runs register-resident independent chains on every SM; a kernel
built from these primitives cannot beat their isolated rates, so a bound
from them holds. Rates are work/second, differenced between loop counts L
and 2L timed with CUDA events, L growing until one launch takes at least a
quarter second, which cancels the launch overhead (``peaks.py:66-99``).
Measured once per process and cached. There is no CPU measurement: every
function here raises without a CUDA device.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable

import torch

from ..kernels import peaks as k5

MIN_SECONDS = 0.25  # one launch at the final loop count takes at least this


def _cuda(device: torch.device | str) -> torch.device:
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("peak rates are measured on a CUDA device only")
    return device


def device_ms(fn: Callable[[], object], reps: int = 20) -> float:
    """Device milliseconds per call of ``fn`` over ``reps`` calls after a
    warm-up call, without the host's time between launches: the calls are
    queued behind a sleep kernel that outlasts their queueing, so the CUDA
    events around them time the card's back-to-back run (the sleep doubles
    until it does)."""
    fn()
    torch.cuda.synchronize()
    cycles = 20_000_000
    while True:
        slept, start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        t0 = time.perf_counter()
        slept.record()
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        queued_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if queued_ms < slept.elapsed_time(start):
            return start.elapsed_time(stop) / reps
        cycles *= 2


def differenced_rate(
    launch: Callable[[int], object],
    work_per_loop: float,
    loops: int = 4,
    reps: int = 3,
    min_seconds: float = MIN_SECONDS,
) -> float:
    """work/second of ``launch(L)``, which does ``work_per_loop * L`` work:
    the difference of the median CUDA-event times of L and 2L (``reps``
    launches each), with L grown from ``loops`` until one launch takes at
    least ``min_seconds``."""

    def timed(n: int, reps_: int) -> float:
        ts = []
        for _ in range(reps_):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            launch(n)
            stop.record()
            stop.synchronize()
            ts.append(start.elapsed_time(stop) / 1e3)
        return statistics.median(ts)

    launch(loops)  # warm-up: build, load, first launch
    t1 = timed(loops, 1)
    while t1 < min_seconds and loops < (1 << 24):
        loops *= max(2, min(int(1.6 * min_seconds / max(t1, 1e-4)), 64))
        t1 = timed(loops, 1)
    t1, t2 = timed(loops, reps), timed(2 * loops, reps)
    return work_per_loop * loops / max(t2 - t1, 1e-9)


def _chain_rate(kind: str, t: int, device: torch.device | str) -> float:
    device = _cuda(device)
    threads = k5.threads_to_fill(kind, device, t or 16)
    table, init = k5.chain_inputs(kind, threads, t or 16)
    init = torch.as_tensor(init, device=device)
    work = threads * k5.CHAINS * k5.STEPS
    if table is None:
        return differenced_rate(lambda n: k5.float_chain(kind, init, n), work)
    table = torch.as_tensor(table, device=device)
    return differenced_rate(lambda n: k5.lookup_chain(kind, table, init, n), work)


def measure_lookup1d_peak(t: int, device: torch.device | str = "cuda") -> float:
    """1-D lookups/second from a byte table of ``t`` entries (K5a)."""
    return _chain_rate("lookup1d", t, device)


def measure_lookup2d_peak(
    t: int, device: torch.device | str = "cuda", lanes: bool = False
) -> float:
    """Pairwise-LUT lookups/second for ``t`` x ``t`` tables (K5b), shared
    by the block or, with ``lanes``, copied per lane."""
    return _chain_rate("lookup2d_lanes" if lanes else "lookup2d", t, device)


def measure_float_binop_peak(op: str, device: torch.device | str = "cuda") -> float:
    """Applications/second of the float op ``op`` of ``kernels.peaks.FLOAT_OPS``
    (K5c)."""
    return _chain_rate(op, 0, device)


_CACHE: dict = {}


def primitive_peak(kind: str, *params) -> float:
    """Cached peak on the current CUDA device: ('lookup1d', T) |
    ('lookup2d', T) | ('lookup2d_lanes', T) | 'minsum_op' | 'boxplus' |
    'float_mix' | 'min'."""
    key = (kind, *params)
    if key not in _CACHE:
        if kind == "lookup1d":
            _CACHE[key] = measure_lookup1d_peak(*params)
        elif kind in ("lookup2d", "lookup2d_lanes"):
            _CACHE[key] = measure_lookup2d_peak(*params, lanes=kind == "lookup2d_lanes")
        elif kind in k5.FLOAT_OPS and not params:
            _CACHE[key] = measure_float_binop_peak(kind)
        else:
            raise ValueError(f"unknown primitive {key!r}")
    return _CACHE[key]


def lookup2d_peak(t: int, peak: Callable[..., float] = primitive_peak) -> float:
    """The pairwise-lookup peak a bound uses: the faster of K5b's two table
    layouts, since a decoder may hold its tables either way."""
    return max(peak("lookup2d", t), peak("lookup2d_lanes", t))
