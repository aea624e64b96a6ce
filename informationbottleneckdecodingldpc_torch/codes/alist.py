"""AList parity-check-matrix format (MacKay's format).

Reference behavior: the reference repo parses AList into a dense 0/1 numpy
array in five duplicated copies of ``alistToNumpy``
(e.g. ``Discrete_LDPC_decoding/discrete_LDPC_decoder.py:57-81`` there).
Here the parser is a single function producing a scipy CSR matrix directly,
including support for the same "reduced" AList variant (weight lines and
row-based blocks omitted) and for the padded-with-zeros entries emitted for
irregular codes.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def parse_alist(lines: list[list[int]]) -> sp.csr_matrix:
    """Parse already-tokenized AList integer lines into a CSR 0/1 matrix.

    Accepts both full AList (with column/row weight lines) and the reduced
    format where lines 3/4 and the row-based tail are omitted, mirroring
    ``alistToNumpy`` in the reference (discrete_LDPC_decoder.py:57).
    AList stores columns first: line 0 is ``ncols nrows``.
    """
    n_cols, n_rows = lines[0]
    if len(lines) > 3 and len(lines[2]) == n_cols and len(lines[3]) == n_rows:
        start = 4
    else:
        start = 2

    indptr = np.zeros(n_cols + 1, dtype=np.int64)
    col_rows: list[np.ndarray] = []
    for col in range(n_cols):
        entries = np.asarray(lines[start + col], dtype=np.int64)
        entries = entries[entries != 0] - 1  # AList is 1-based; 0 pads
        col_rows.append(np.sort(entries))
        indptr[col + 1] = indptr[col] + entries.size

    indices = np.concatenate(col_rows) if col_rows else np.zeros(0, np.int64)
    data = np.ones(indices.size, dtype=np.int8)
    csc = sp.csc_matrix((data, indices, indptr), shape=(n_rows, n_cols))
    return csc.tocsr()


def alist_to_csr(path: str) -> sp.csr_matrix:
    """Read an AList file from disk into a CSR matrix."""
    with open(path) as f:
        lines = [list(map(int, ln.split())) for ln in f if ln.strip()]
    return parse_alist(lines)


def format_alist(H: sp.spmatrix) -> str:
    """Serialize a 0/1 matrix to full AList text."""
    H = sp.csr_matrix(H)
    n_rows, n_cols = H.shape
    csc = H.tocsc()
    col_deg = np.diff(csc.indptr)
    row_deg = np.diff(H.indptr)
    out = [f"{n_cols} {n_rows}", f"{col_deg.max(initial=0)} {row_deg.max(initial=0)}"]
    out.append(" ".join(map(str, col_deg)))
    out.append(" ".join(map(str, row_deg)))
    d_c_max = int(col_deg.max(initial=0))
    d_r_max = int(row_deg.max(initial=0))
    for c in range(n_cols):
        rows = csc.indices[csc.indptr[c] : csc.indptr[c + 1]] + 1
        padded = list(rows) + [0] * (d_c_max - rows.size)
        out.append(" ".join(map(str, padded)))
    for r in range(n_rows):
        cols = H.indices[H.indptr[r] : H.indptr[r + 1]] + 1
        padded = list(cols) + [0] * (d_r_max - cols.size)
        out.append(" ".join(map(str, padded)))
    return "\n".join(out) + "\n"


def csr_to_alist(H: sp.spmatrix, path: str) -> None:
    """Write matrix to an AList file."""
    with open(path, "w") as f:
        f.write(format_alist(H))
