"""The encoded chain's systematic encoder on the card, and its plain version.

:class:`DeviceEncoder` maps a step's info bits [K, batch] to int8 codewords
[N, batch], the systematic rows first. H = [A | B]; s = A u over GF(2), s_r
the XOR of row r's info columns; then p solves B p = s on one of two paths,
chosen by what the code is:

- staircase B (DVB-S2, any accumulator code): p is the prefix XOR of s;
- otherwise, for m = N - K <= :data:`DENSE_INVERSE_MAX_CHECKS`: p = B^-1 s
  with the dense GF(2) inverse of B made once on the host.

For a CUDA tensor the wrapper launches ``csrc/encoder.cu``, one launch a
call, counted in ``launches``: a single-pass scan with decoupled look-back on
the staircase path, an AND-popcount product over B^-1's rows packed into
32-bit words (:func:`pack_rows`) on the dense one. For a CPU tensor it runs
the plain version :meth:`DeviceEncoder.plain`, the torch closure the device
path ran before the kernel (gathers and XORs, a transposed int32 ``cumsum``
or a float32 GEMM, whose entries are 0/1 and sums at most m, all exact, even
in TF32). There is no fallback from one to the other.

The kernel replaces no Pallas kernel: the JAX package encodes with XLA
(``informationbottleneckdecodingldpc_tpu/encode/encoder.py``
``device_encoder``).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

DENSE_INVERSE_MAX_CHECKS = 4096  # kMaxDenseChecks in csrc/encoder.cu
DENSE_GROUP = 32  # codewords of a dense block, a lane each
DENSE_MIN_ROWS = 128  # parity rows of a dense block, at least, where rows are split
WORD_BYTES = (16, 1)  # the staircase path's column words, widest first


def pack_rows(rows: np.ndarray) -> np.ndarray:
    """0/1 rows [m, n] as uint32 words [m, stride]: bit j of word w of row i
    is rows[i, 32 w + j]; stride is ceil(n / 128) * 4 (16-byte rows), the
    padding zero."""
    m, n = rows.shape
    stride = -(-n // 128) * 4
    bits = np.zeros((m, stride * 32), dtype=np.uint8)
    bits[:, :n] = rows
    return np.packbits(bits, axis=1, bitorder="little").view("<u4")


def dense_splits(m: int, batch: int, sms: int) -> int:
    """Blocks the dense path splits the parity rows of a group of
    :data:`DENSE_GROUP` codewords over: enough for two blocks an SM, each
    with at least :data:`DENSE_MIN_ROWS` rows."""
    groups = -(-batch // DENSE_GROUP)
    return max(1, min(-(-2 * sms // groups), -(-m // DENSE_MIN_ROWS)))


class DeviceEncoder:
    """The encoder on ``device`` of a code with K = ``k`` info bits and N =
    ``n`` codeword bits: A's rows as CSR (``row_ptr``, ``col_idx``) and
    ``inverse``, the dense GF(2) inverse of B as 0/1 [m, m], or None for a
    staircase B. Calling it maps info bits [K, batch] (0/1, any integer type)
    on ``device`` to int8 codewords [N, batch]. The staircase kernel's state
    buffer is reused across calls of one shape and made anew, zeroed, for
    another, so calls on the card go to one stream at a time."""

    def __init__(self, k: int, n: int, row_ptr: np.ndarray, col_idx: np.ndarray,
                 inverse: np.ndarray | None, device: torch.device | str):
        self.k, self.n = int(k), int(n)
        m = self.n - self.k
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.is_staircase = inverse is None
        self.launches = 0
        # Each check's info columns, padded with -1 to a multiple of 4 (the
        # kernel reads them in quads).
        row_ptr = np.asarray(row_ptr, dtype=np.int64)
        deg = np.diff(row_ptr)
        self._width = max(1, int(deg.max()))
        rows = np.repeat(np.arange(m), deg)
        table = np.full((m, -(-self._width // 4) * 4), -1, dtype=np.int32)
        table[rows, np.arange(len(col_idx)) - row_ptr[rows]] = col_idx
        self._table = torch.as_tensor(table, device=self.device)
        self._inverse = inverse  # 0/1 [m, m] on the host, or None
        self._plain_tables = None  # on the device at the plain version's first call
        if self.device.type == "cuda":
            self._packed = None
            if inverse is not None:
                self._packed = torch.as_tensor(pack_rows(inverse).view(np.int32), device=self.device)
            self._sms = torch.cuda.get_device_properties(self.device).multi_processor_count
            self._state, self._state_shape = None, None

    def __call__(self, info: torch.Tensor) -> torch.Tensor:
        if info.device.type == "cpu":
            return self.plain(info)
        return self._launch(info)

    def plain(self, info: torch.Tensor) -> torch.Tensor:
        """The plain version, on any device the tables are on."""
        if self._plain_tables is None:
            # The columns slot-major [max_deg, m], padded with index K (a
            # row of zeros), and B^-1 in float32.
            cols = torch.where(self._table < 0, self.k, self._table)[:, : self._width]
            inverse = None
            if self._inverse is not None:
                inverse = torch.as_tensor(self._inverse.astype(np.float32), device=self.device)
            self._plain_tables = (cols.t().to(torch.int64).contiguous(), inverse)
        cols, inverse = self._plain_tables
        u = info.to(torch.int8)
        u_pad = torch.cat([u, u.new_zeros((1, u.shape[1]))])
        s = u_pad[cols[0]]
        for c in cols[1:]:
            s = s ^ u_pad[c]
        if inverse is None:
            # Scanned along the contiguous dimension: torch's scan over the
            # outer one walks each column's m rows in sequence (11.9 ms for
            # DVB-S2 at batch 1024 on an H100).
            scan = torch.cumsum(s.t().contiguous(), dim=1, dtype=torch.int32)
            parity = scan.t() & 1
        else:
            parity = (inverse @ s.to(torch.float32)).to(torch.int32) & 1
        return torch.cat([u, parity.to(torch.int8)])

    def _launch(self, info: torch.Tensor) -> torch.Tensor:
        if self.device.type != "cuda" or info.device != self.device:
            raise ValueError(f"the encoder's tables are on {self.device}, the info bits on {info.device}")
        if info.dim() != 2 or info.shape[0] != self.k:
            raise ValueError(f"expected info bits [{self.k}, batch], got {tuple(info.shape)}")
        u = info.to(torch.int8).contiguous()
        batch, m = u.shape[1], self.n - self.k
        out = torch.empty((self.n, batch), dtype=torch.int8, device=self.device)
        if batch == 0:
            return out
        lib = _library()
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream(self.device).cuda_stream
            if self.is_staircase:
                word = next(w for w in WORD_BYTES if batch % w == 0 and u.data_ptr() % w == 0)
                if self._state_shape != (batch, word):
                    words = lib.value("encoder_state_words", m, batch, word)
                    self._state = torch.zeros(words, dtype=torch.int32, device=self.device)
                    self._state_shape = (batch, word)
                lib.launch("encoder_staircase", u.data_ptr(), out.data_ptr(), self._table.data_ptr(),
                           self._table.shape[1] // 4, self._state.data_ptr(), self.k, m, batch, word,
                           stream)
            else:
                lib.launch("encoder_dense", u.data_ptr(), out.data_ptr(), self._table.data_ptr(),
                           self._table.shape[1] // 4, self._packed.data_ptr(), self.k, m, batch,
                           self._packed.shape[1], dense_splits(m, batch, self._sms), stream)
        self.launches += 1
        return out


@functools.cache
def _library():
    """The encoder's library, built at first use."""
    from ._build import CLibrary

    p, i = ctypes.c_void_p, ctypes.c_int
    lib = CLibrary("encoder", {
        "encoder_staircase": [p, p, p, i, p, i, i, i, i, p],
        "encoder_dense": [p, p, p, i, p, i, i, i, i, i, p],
        "encoder_state_words": [i, i, i],
        "encoder_max_dense_checks": [],
    })
    if lib.value("encoder_max_dense_checks") != DENSE_INVERSE_MAX_CHECKS:
        raise RuntimeError(f"csrc/encoder.cu takes {lib.value('encoder_max_dense_checks')} dense "
                           f"checks, the wrapper {DENSE_INVERSE_MAX_CHECKS}")
    return lib
