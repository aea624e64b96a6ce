"""GF(2) linear algebra for encoder setup (host-side, bit-packed numpy).

Functional equivalent of the reference's factorization machinery
(Discrete_LDPC_decoding/LDPC_encoder.py:287-362) redesigned around packed
uint64 row operations: triangularity detection, and LU-style factorization
X = L·U with row pivoting where L is unit lower triangular (first-candidate
pivoting guarantees triangularity, see gf2factorize's invariant) and
U[row_order] is unit upper triangular.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp


def is_full_diag_triangular(X: sp.spmatrix) -> int:
    """1 if lower triangular with full diagonal, -1 if upper, else 0.

    Same decision rule as the reference's ``isfulldiagtriangular``
    (LDPC_encoder.py:342-362).
    """
    X = sp.csr_matrix(X)
    n = X.shape[0]
    if not np.all(X.diagonal()):
        return 0
    nnz_lower = int((sp.tril(X) != 0).sum())
    if nnz_lower == X.nnz:
        return 1
    if nnz_lower == n:
        return -1
    return 0


@dataclasses.dataclass
class GF2Factorization:
    """X = L @ U over GF(2) with first-candidate row pivoting.

    ``l_strict``: strictly-lower part of unit-lower-triangular L (CSC).
    ``u_strict_permuted``: strictly-upper part of U[row_order] (CSC).
    ``row_order``: pivot row per elimination column.
    """

    l_strict: sp.csc_matrix
    u_strict_permuted: sp.csc_matrix
    row_order: np.ndarray
    invertible: bool


def _pack_rows(dense: np.ndarray) -> np.ndarray:
    m, n = dense.shape
    words = (n + 63) // 64
    padded = np.zeros((m, words * 64), dtype=np.uint8)
    padded[:, :n] = dense.astype(np.uint8) & 1
    by = np.packbits(padded.reshape(m, words, 8, 8)[:, :, :, ::-1], axis=-1)
    return np.ascontiguousarray(by.reshape(m, words, 8)).view(np.uint64).reshape(m, words)


def _unpack_rows(packed: np.ndarray, n: int) -> np.ndarray:
    m, words = packed.shape
    as_bytes = packed.reshape(m, words, 1).view(np.uint8)
    bits = np.unpackbits(as_bytes, axis=-1).reshape(m, words, 8, 8)[:, :, :, ::-1]
    return bits.reshape(m, words * 64)[:, :n].astype(np.uint8)


def gf2_factorize_packed(X: sp.spmatrix | np.ndarray) -> GF2Factorization:
    """Gaussian elimination over GF(2) with packed-row XOR updates."""
    dense = X.toarray() if sp.issparse(X) else np.asarray(X)
    m = dense.shape[0]
    if dense.shape[1] != m:
        raise ValueError("square matrix required")
    rows = _pack_rows(dense)
    available = np.ones(m, dtype=bool)
    pivots = np.zeros(m, dtype=np.int64)
    l_rows: list[np.ndarray] = []
    l_cols: list[np.ndarray] = []
    invertible = True

    for col in range(m):
        w, b = divmod(col, 64)
        has_bit = ((rows[:, w] >> np.uint64(b)) & np.uint64(1)).astype(bool)
        cand = np.nonzero(has_bit & available)[0]
        if cand.size == 0:
            invertible = False
            break
        pivot = int(cand[0])
        pivots[col] = pivot
        available[pivot] = False
        rest = cand[1:]
        if rest.size:
            rows[rest] ^= rows[pivot]
            l_rows.append(rest)
            l_cols.append(np.full(rest.size, pivot, dtype=np.int64))

    if not invertible:
        return GF2Factorization(
            l_strict=sp.csc_matrix((m, m), dtype=np.int8),
            u_strict_permuted=sp.csc_matrix((m, m), dtype=np.int8),
            row_order=np.zeros(m, dtype=np.int64),
            invertible=False,
        )

    lr = np.concatenate(l_rows) if l_rows else np.zeros(0, np.int64)
    lc = np.concatenate(l_cols) if l_cols else np.zeros(0, np.int64)
    # First-candidate pivoting guarantees every eliminated row index exceeds
    # its pivot's, so L is strictly lower triangular as built.
    l_strict = sp.csc_matrix(
        (np.ones(lr.size, dtype=np.int8), (lr, lc)), shape=(m, m)
    )
    u_perm = _unpack_rows(rows[pivots], m)
    u_strict = sp.csc_matrix(np.triu(u_perm, 1))
    return GF2Factorization(
        l_strict=l_strict,
        u_strict_permuted=u_strict,
        row_order=pivots,
        invertible=True,
    )


def is_staircase(B: sp.spmatrix) -> bool:
    """True if B is the IRA accumulator: unit diagonal + unit subdiagonal."""
    B = sp.csr_matrix(B)
    m = B.shape[0]
    expected_nnz = 2 * m - 1
    if B.nnz != expected_nnz:
        return False
    if not np.all(B.diagonal() == 1):
        return False
    return bool(np.all(np.asarray(B.diagonal(-1)).ravel() == 1))
