"""Primitive peak-rate microkernels K5a, K5b, K5c and their plain versions.

Port of the Pallas microkernels of ``utils/peaks.py`` (``measure_extract_peak``,
``measure_column_peak``, ``_measure_float_binop``). Each runs ``CHAINS``
independent chains per thread, ``STEPS`` applications per chain per loop
iteration, ``loops`` times, and returns the per-thread sum of the final
states (``csrc/peaks.cu`` says what each kernel times and what bounds it):

- ``lookup1d``: s = row[s], a byte table of T entries (the 1-D remap);
- ``lookup2d``: a = lut[l][a, b]; b = lut[l'][b, a], ``SLOTS`` T x T LUTs,
  slot ``j % SLOTS`` for the j-th lookup of a loop iteration, one copy of
  the tables per block;
- ``lookup2d_lanes``: the same chains with a copy of the tables per lane
  (no bank conflicts), in blocks of ``LANES_THREADS``;
- the float ops of :data:`FLOAT_OPS`: x = op(x, y); y = op(y, -x).

For a CUDA tensor a wrapper launches the kernel over as many threads as the
states have columns (a multiple of the kind's block, :func:`block_threads`;
:func:`threads_to_fill` fills the card) and counts the launch in
:data:`launches`; for a CPU tensor it runs the plain version, which
computes the same states by indexing and with the port's
``ops/float_ops.py``. There is no fallback from one to the other.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import numpy as np
import torch

from ..ops.float_ops import LLR_MAX, boxplus, min_sum_op

THREADS = 256  # kThreads in csrc/peaks.cu
CHAINS = 16  # kChains
STEPS = 64  # kSteps: applications per chain per loop iteration
SLOTS = 4  # kSlots: LUT slots of the 2-D chain
LANES_THREADS = 1024  # kLanesThreads: the block of the per-lane-copy chain
LOOKUPS = ("lookup1d", "lookup2d", "lookup2d_lanes")

# The float ops, as K2 and K4 compute them.
FLOAT_OPS = {
    "minsum_op": min_sum_op,
    "boxplus": boxplus,
    "float_mix": lambda a, b: torch.clamp(a + b, -LLR_MAX, LLR_MAX),
    "min": torch.minimum,
}
_KIND = {
    "lookup1d": 0, "lookup2d": 1, "minsum_op": 2, "boxplus": 3, "float_mix": 4, "min": 5,
    "lookup2d_lanes": 6,
}

# Kernel launches per variant (:func:`variant`); the plain versions do not
# count.
launches: collections.Counter = collections.Counter()


def variant(kind: str, t: int = 0) -> str:
    """A kernel variant's name: the lookup chains per table size T
    ('lookup2d_T16'), a float op by its name."""
    return f"{kind}_T{t}" if kind in LOOKUPS else kind


def block_threads(kind: str) -> int:
    """Threads of one block of the kernel of ``kind``."""
    return LANES_THREADS if kind == "lookup2d_lanes" else THREADS


def chain_inputs(
    kind: str, threads: int, t: int = 16, seed: int = 0
) -> tuple[np.ndarray | None, np.ndarray]:
    """Seeded numpy inputs of a chain: the table (uint8: T entries for
    ``lookup1d``, [SLOTS, T, T] for the 2-D chains, None for a float op) and
    the initial states ([CHAINS or 2 CHAINS, threads]: int32 in [0, T), or
    float32 LLR-sized normals, x then y)."""
    rng = np.random.default_rng(seed)
    if kind == "lookup1d":
        return (
            rng.integers(0, t, t).astype(np.uint8),
            rng.integers(0, t, (CHAINS, threads)).astype(np.int32),
        )
    if kind in ("lookup2d", "lookup2d_lanes"):
        return (
            rng.integers(0, t, (SLOTS, t, t)).astype(np.uint8),
            rng.integers(0, t, (2 * CHAINS, threads)).astype(np.int32),
        )
    if kind not in FLOAT_OPS:
        raise ValueError(f"unknown primitive {kind!r}")
    return None, (4.0 * rng.standard_normal((2 * CHAINS, threads))).astype(np.float32)


def lookup_chain_plain(
    kind: str, table: torch.Tensor, init: torch.Tensor, loops: int
) -> torch.Tensor:
    """Plain version of K5a / K5b (both table layouts): the same chains by
    indexing; int32 per-thread sums of the final states."""
    lut = table.long()
    if kind == "lookup1d":
        s = init.long()
        for _ in range(loops * STEPS):
            s = lut[s]
        return s.sum(0).to(torch.int32)
    a, b = init[:CHAINS].long(), init[CHAINS:].long()
    for _ in range(loops):
        for k in range(0, STEPS, 2):
            a = lut[k % SLOTS][a, b]
            b = lut[(k + 1) % SLOTS][b, a]
    return (a.sum(0) + b.sum(0)).to(torch.int32)


def float_pair_states(
    op: str, x: torch.Tensor, y: torch.Tensor, pair_steps: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """``pair_steps`` steps x = op(x, y); y = op(y, -x) of the float chains
    with the port's float ops (two applications a step)."""
    f = FLOAT_OPS[op]
    for _ in range(pair_steps):
        x = f(x, y)
        y = f(y, -x)
    return x, y


def float_chain_plain(op: str, init: torch.Tensor, loops: int) -> torch.Tensor:
    """Plain version of K5c: float32 per-thread sums x_0 + x_1 + ... of the
    final states, in chain order."""
    x, _ = float_pair_states(op, init[:CHAINS], init[CHAINS:], loops * STEPS // 2)
    acc = x[0]
    for c in range(1, CHAINS):
        acc = acc + x[c]
    return acc


def _check_states(init: torch.Tensor, rows: int, dtype: torch.dtype, block: int = THREADS) -> int:
    if init.dtype != dtype or init.dim() != 2 or init.shape[0] != rows:
        raise ValueError(f"states must be {dtype} [{rows}, threads], got {init.dtype} {tuple(init.shape)}")
    if init.shape[1] % block:
        raise ValueError(f"threads must be a multiple of {block}, got {init.shape[1]}")
    return init.shape[1] // block


def lookup_chain(
    kind: str, table: torch.Tensor, init: torch.Tensor, loops: int
) -> torch.Tensor:
    """K5a (``kind`` 'lookup1d') or K5b ('lookup2d', 'lookup2d_lanes') on
    CUDA tensors, the plain version on CPU tensors."""
    if kind not in LOOKUPS:
        raise ValueError(f"unknown lookup chain {kind!r}")
    if init.device.type == "cpu":
        return lookup_chain_plain(kind, table, init, loops)
    t = table.shape[-1]
    shape = (t,) if kind == "lookup1d" else (SLOTS, t, t)
    if table.dtype != torch.uint8 or tuple(table.shape) != shape or not 1 <= t <= 32:
        raise ValueError(f"the table must be uint8 {shape} with T <= 32")
    rows = CHAINS if kind == "lookup1d" else 2 * CHAINS
    blocks = _check_states(init, rows, torch.int32, block_threads(kind))
    table, init = table.contiguous(), init.contiguous()
    out = torch.empty(init.shape[1], dtype=torch.int32, device=init.device)
    with torch.cuda.device(init.device):
        stream = torch.cuda.current_stream(init.device).cuda_stream
        _library().launch(
            "peaks_lookup", _KIND[kind], table.data_ptr(), init.data_ptr(),
            out.data_ptr(), t, loops, blocks, stream,
        )
    launches[variant(kind, t)] += 1
    return out


def float_chain(op: str, init: torch.Tensor, loops: int) -> torch.Tensor:
    """K5c for ``op`` of :data:`FLOAT_OPS` on a CUDA tensor, the plain
    version on a CPU tensor."""
    if op not in FLOAT_OPS:
        raise ValueError(f"unknown float op {op!r}")
    if init.device.type == "cpu":
        return float_chain_plain(op, init, loops)
    blocks = _check_states(init, 2 * CHAINS, torch.float32)
    init = init.contiguous()
    out = torch.empty(init.shape[1], dtype=torch.float32, device=init.device)
    with torch.cuda.device(init.device):
        stream = torch.cuda.current_stream(init.device).cuda_stream
        _library().launch(
            "peaks_float", _KIND[op], init.data_ptr(), out.data_ptr(), loops, blocks, stream
        )
    launches[op] += 1
    return out


def threads_to_fill(kind: str, device: torch.device | str, t: int = 16) -> int:
    """Threads of a launch that fills every SM of the CUDA ``device`` with
    the kernel of ``kind`` at table size ``t``."""
    blocks = ctypes.c_int(0)
    with torch.cuda.device(torch.device(device)):
        _library().launch("peaks_blocks", _KIND[kind], t, ctypes.byref(blocks))
    return blocks.value * block_threads(kind)


@functools.cache
def _library():
    """K5's library, built at first use."""
    from ._build import CLibrary

    p, i = ctypes.c_void_p, ctypes.c_int
    lib = CLibrary("peaks", {
        "peaks_lookup": [i, p, p, p, i, i, i, p],
        "peaks_float": [i, p, p, i, i, p],
        "peaks_blocks": [i, i, ctypes.POINTER(i)],
        "peaks_threads": [], "peaks_lanes_threads": [], "peaks_chains": [], "peaks_steps": [],
        "peaks_slots": [],
    })
    constants = (("threads", THREADS), ("lanes_threads", LANES_THREADS), ("chains", CHAINS),
                 ("steps", STEPS), ("slots", SLOTS))
    for name, want in constants:
        if lib.value(f"peaks_{name}") != want:
            raise RuntimeError(f"csrc/peaks.cu and kernels/peaks.py disagree on {name}")
    return lib
