"""IEEE 802.11n (WLAN) LDPC parity-check matrix, N=1296, R=1/2, Z=54.

Builds H from the standard's circulant-exponent base matrix (IEEE 802.11-2012
Annex F). Produces the same matrix as the reference generator script
(Irregular_LDPC_Decoding/WLAN/generate_802.11_matrix.py:7-37): entry ``e >= 0``
expands to the ZxZ identity cyclically shifted by ``e`` columns; ``-1`` expands
to the ZxZ zero block.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

# Standard base matrix: 12 x 24 blocks, Z = 54 (N=1296, K=648, R=1/2).
_BASE_1296_12 = [
    [40, -1, -1, -1, 22, -1, 49, 23, 43, -1, -1, -1, 1, 0, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1],
    [50, 1, -1, -1, 48, 35, -1, -1, 13, -1, 30, -1, -1, 0, 0, -1, -1, -1, -1, -1, -1, -1, -1, -1],
    [39, 50, -1, -1, 4, -1, 2, -1, -1, -1, -1, 49, -1, -1, 0, 0, -1, -1, -1, -1, -1, -1, -1, -1],
    [33, -1, -1, 38, 37, -1, -1, 4, 1, -1, -1, -1, -1, -1, -1, 0, 0, -1, -1, -1, -1, -1, -1, -1],
    [45, -1, -1, -1, 0, 22, -1, -1, 20, 42, -1, -1, -1, -1, -1, -1, 0, 0, -1, -1, -1, -1, -1, -1],
    [51, -1, -1, 48, 35, -1, -1, -1, 44, -1, 18, -1, -1, -1, -1, -1, -1, 0, 0, -1, -1, -1, -1, -1],
    [47, 11, -1, -1, -1, 17, -1, -1, 51, -1, -1, -1, 0, -1, -1, -1, -1, -1, 0, 0, -1, -1, -1, -1],
    [5, -1, 25, -1, 6, -1, 45, -1, 13, 40, -1, -1, -1, -1, -1, -1, -1, -1, -1, 0, 0, -1, -1, -1],
    [33, -1, -1, 34, 24, -1, -1, -1, 23, -1, -1, 46, -1, -1, -1, -1, -1, -1, -1, -1, 0, 0, -1, -1],
    [1, -1, 27, -1, 1, -1, -1, -1, 38, -1, 44, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, 0, 0, -1],
    [-1, 18, -1, -1, 23, -1, -1, 8, 0, 35, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, 0, 0],
    [49, -1, 17, -1, 30, -1, -1, -1, 34, -1, -1, 19, 1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, 0],
]


def expand_base_matrix(base: np.ndarray, Z: int) -> sp.csr_matrix:
    """Expand a circulant-exponent base matrix into a sparse 0/1 H.

    Shift convention matches ``np.roll(np.eye(Z), e, axis=1)``: block entry
    ``(i, j)`` is 1 iff ``j == (i + e) mod Z``.
    """
    base = np.asarray(base)
    rows, cols, Zr = [], [], np.arange(Z, dtype=np.int64)
    for bi in range(base.shape[0]):
        for bj in range(base.shape[1]):
            e = int(base[bi, bj])
            if e < 0:
                continue
            rows.append(bi * Z + Zr)
            cols.append(bj * Z + (Zr + e) % Z)
    r = np.concatenate(rows)
    c = np.concatenate(cols)
    H = sp.coo_matrix(
        (np.ones(r.size, dtype=np.int8), (r, c)),
        shape=(base.shape[0] * Z, base.shape[1] * Z),
    )
    return H.tocsr()


def wlan_80211n_parity_check() -> sp.csr_matrix:
    """The 648x1296 IEEE 802.11n rate-1/2 parity-check matrix (Z=54)."""
    return expand_base_matrix(np.asarray(_BASE_1296_12), 54)
