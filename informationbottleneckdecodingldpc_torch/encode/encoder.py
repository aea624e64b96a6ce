"""Systematic LDPC encoding: the host encoder and its device path.

The host encoder ``LDPCEncoder`` is the port's copy of the JAX package's
``encode/encoder.py`` host code, with the same capability as the reference's
``LDPCEncoder`` (Discrete_LDPC_decoding/LDPC_encoder.py): split H = [A | B]
with B the last (N-K) columns, detect whether B (or its row-reversal) is
triangular, otherwise factorize B = L·U over GF(2); parity bits solve
B p = A u by substitution, batched and bit-packed, in numpy. The JAX
package also builds C++ kernels for this host path; the port has no caller
that needs their speed (the simulator encodes on the device), so it keeps
the numpy path only.

``device_encoder`` is the port of ``LDPCEncoder.device_encoder``: it carries
the host encoder's matrices to a torch device once, as the tables of
``kernels/encoder.py`` ``DeviceEncoder`` (one kernel launch a call on the
card, its plain version on the CPU):

- s = A u over GF(2), as an XOR of gathered info bits per check;
- staircase B (accumulator codes such as DVB-S2): p is the prefix XOR of s;
- otherwise, for m = N - K <= 4096: p = B^-1 s with the dense GF(2) inverse
  of B made once on the host.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from ..kernels.encoder import DENSE_INVERSE_MAX_CHECKS, DeviceEncoder
from ..utils.bitpack import pack_bits, unpack_bits
from .gf2 import gf2_factorize_packed, is_full_diag_triangular, is_staircase


def _csc_arrays(X: sp.spmatrix):
    X = sp.csc_matrix(X)
    return X.indptr.astype(np.int32), X.indices.astype(np.int32)


def _np_accumulate(indptr, indices, src, dst):
    for c in range(len(indptr) - 1):
        if not src[c].any():
            continue
        for k in range(indptr[c], indptr[c + 1]):
            dst[indices[k]] ^= src[c]


def _np_substitute(indptr, indices, data, direction):
    n = len(indptr) - 1
    cols = range(n) if direction == 1 else range(n - 1, -1, -1)
    for c in cols:
        if not data[c].any():
            continue
        for k in range(indptr[c], indptr[c + 1]):
            data[indices[k]] ^= data[c]


class LDPCEncoder:
    """Encoder built once from H; ``encode`` maps [K, batch] info bits to
    [N, batch] codewords with the systematic bits first."""

    def __init__(self, H: sp.spmatrix):
        H = sp.csr_matrix(H)
        H.sum_duplicates()
        H.data[:] = 1
        self.H = H
        self.n = H.shape[1]
        self.k = self.n - H.shape[0]
        m = H.shape[0]
        if self.k <= 0:
            raise ValueError("H must have more columns than rows")
        A = sp.csc_matrix(H[:, : self.k])
        B = sp.csc_matrix(H[:, self.k :])
        self._a_indptr, self._a_indices = _csc_arrays(A)
        self.B = B
        self.is_staircase = is_staircase(B)

        shape = is_full_diag_triangular(B)
        self.row_order: np.ndarray | None = None
        self._l: tuple | None = None
        if shape == 1:
            self.method = "lower"
            P = sp.tril(B, -1)
            self._b_dir = 1
        elif shape == -1:
            self.method = "upper"
            P = sp.triu(B, 1)
            self._b_dir = -1
        else:
            rev = sp.csc_matrix(B.toarray()[::-1, :])
            rshape = is_full_diag_triangular(rev)
            if rshape != 0:
                self.method = "reversed"
                self.row_order = np.arange(m)[::-1]
                P = sp.tril(rev, -1) if rshape == 1 else sp.triu(rev, 1)
                self._b_dir = 1 if rshape == 1 else -1
            else:
                fact = gf2_factorize_packed(B)
                if not fact.invertible:
                    raise ValueError(
                        "last N-K columns of H are singular over GF(2); "
                        "permute columns or use a different code"
                    )
                self.method = "factorized"
                self.row_order = fact.row_order
                self._l = _csc_arrays(fact.l_strict)
                P = fact.u_strict_permuted
                self._b_dir = -1
        self._b_indptr, self._b_indices = _csc_arrays(P)

    # ------------------------------------------------------------------
    def encode(self, info_bits: np.ndarray) -> np.ndarray:
        """Host path: info_bits [K, batch] -> codewords [N, batch] int8."""
        info_bits = np.asarray(info_bits)
        if info_bits.ndim == 1:
            info_bits = info_bits[:, None]
        k, batch = info_bits.shape
        if k != self.k:
            raise ValueError(f"expected {self.k} info bits, got {k}")
        m = self.n - self.k

        packed_u, _ = pack_bits(info_bits)
        words = packed_u.shape[1]
        s = np.zeros((m, words), dtype=np.uint64)

        _np_accumulate(self._a_indptr, self._a_indices, packed_u, s)
        if self.method == "factorized":
            _np_substitute(self._l[0], self._l[1], s, 1)
        if self.row_order is not None:
            s = np.ascontiguousarray(s[self.row_order])
        _np_substitute(self._b_indptr, self._b_indices, s, self._b_dir)

        parity = unpack_bits(s, batch)
        return np.concatenate([info_bits.astype(np.int8), parity], axis=0)

    # ------------------------------------------------------------------
    def check(self, codewords: np.ndarray) -> np.ndarray:
        """Syndrome H c over GF(2): [n_checks, batch] (0 = valid)."""
        cw = np.asarray(codewords)
        if cw.ndim == 1:
            cw = cw[:, None]
        packed, batch = pack_bits(cw)
        m = self.H.shape[0]
        out = np.zeros((m, packed.shape[1]), dtype=np.uint64)
        for r in range(m):
            for c in self.H.indices[self.H.indptr[r] : self.H.indptr[r + 1]]:
                out[r] ^= packed[c]
        return unpack_bits(out, batch)


def _gf2_dense_inverse(B: np.ndarray) -> np.ndarray | None:
    """Dense GF(2) inverse by Gauss-Jordan; None if singular."""
    m = B.shape[0]
    work = B.astype(np.uint8).copy()
    inv = np.eye(m, dtype=np.uint8)
    for col in range(m):
        pivots = np.nonzero(work[col:, col])[0]
        if pivots.size == 0:
            return None
        p = col + int(pivots[0])
        if p != col:
            work[[col, p]] = work[[p, col]]
            inv[[col, p]] = inv[[p, col]]
        rows = np.nonzero(work[:, col])[0]
        rows = rows[rows != col]
        if rows.size:
            work[rows] ^= work[col]
            inv[rows] ^= inv[col]
    return inv


def device_encoder(enc: LDPCEncoder, device: torch.device | str) -> DeviceEncoder:
    """Carry the host encoder's matrices to ``device``; the returned
    :class:`~..kernels.encoder.DeviceEncoder` maps info bits [K, batch] (0/1,
    any integer type) to int8 codewords [N, batch], systematic bits first:
    one kernel launch on a CUDA device, the plain version on the CPU. Raises
    when B has no device path."""
    k, m = enc.k, enc.n - enc.k
    A = sp.csr_matrix(enc.H[:, :k])
    inv = None
    if not enc.is_staircase:
        if m > DENSE_INVERSE_MAX_CHECKS:
            raise ValueError(
                f"no device encoder for a non-staircase B with {m} checks"
            )
        inv = _gf2_dense_inverse(enc.B.toarray().astype(np.uint8))
        if inv is None:
            raise ValueError("B is singular over GF(2)")
    return DeviceEncoder(k, enc.n, A.indptr, A.indices, inv, device)
