"""Seeded random regular LDPC constructions.

The reference's regular scenario uses MacKay's ``8000.4000.3.483`` matrix
loaded from a file that ships with neither repo
(Regular_LDPC_Decoding/BPSK/BER_simulation_OpenCL.py:35). This module draws an
ensemble-equivalent regular (d_v, d_c) code: exact degree sequence via the
configuration model, duplicate-edge repair, and 4-cycle reduction passes so the
girth is >= 6 like MacKay's construction. BER in the waterfall region is a
property of the ensemble, which is what the parity tests compare.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def regular_qc_parity_check(
    n_vars: int,
    d_v: int = 3,
    d_c: int = 6,
    seed: int = 0,
) -> sp.csr_matrix:
    """Seeded quasi-cyclic regular (d_v, d_c) code, girth >= 6.

    Base biadjacency: the smallest m_b x n_b 0/1 matrix with column weight
    d_v and row weight d_c whose n_b divides n_vars (all-ones minus a
    balanced circulant zero pattern), each 1 expanded to a ZxZ cyclically
    shifted identity with shifts re-drawn until no 4-cycles remain. The block
    structure makes the decode layout's CN<->VN permutation a set of Z-long
    runs (gather-free routing) while staying in the same regular ensemble as
    MacKay-style codes.
    """
    def balanced_base(mb: int, nb: int) -> np.ndarray | None:
        base = np.ones((mb, nb), dtype=np.int8)
        dpr = nb - d_c
        for r in range(mb):
            for t in range(dpr):
                base[r, (r * dpr + t) % nb] = 0
        if (base.sum(1) == d_c).all() and (base.sum(0) == d_v).all():
            return base
        return None

    base = None
    for mb in range(d_v + 1, 16 * d_v + 2):
        if mb * d_c % d_v:
            continue
        nb = mb * d_c // d_v
        if n_vars % nb:
            continue
        base = balanced_base(mb, nb)
        if base is not None:
            m_b, n_b = mb, nb
            break
    if base is None:
        raise ValueError(f"no quasi-cyclic base found for n_vars={n_vars}")
    z = n_vars // n_b

    rng = np.random.default_rng(seed)
    shifts = rng.integers(0, z, size=(m_b, n_b))

    def has_4cycle() -> tuple | None:
        for r1 in range(m_b):
            for r2 in range(r1 + 1, m_b):
                cols = np.nonzero(base[r1] & base[r2])[0]
                for i in range(cols.size):
                    for j in range(i + 1, cols.size):
                        c1, c2 = cols[i], cols[j]
                        if (
                            shifts[r1, c1] - shifts[r1, c2]
                            + shifts[r2, c2] - shifts[r2, c1]
                        ) % z == 0:
                            return r1, c1
        return None

    for _ in range(10_000):
        bad = has_4cycle()
        if bad is None:
            break
        shifts[bad] = rng.integers(0, z)

    rows, cols, zr = [], [], np.arange(z, dtype=np.int64)
    for r in range(m_b):
        for c in range(n_b):
            if base[r, c]:
                rows.append(r * z + zr)
                cols.append(c * z + (zr + shifts[r, c]) % z)
    H = sp.coo_matrix(
        (np.ones(z * base.sum(), dtype=np.int8), (np.concatenate(rows), np.concatenate(cols))),
        shape=(m_b * z, n_b * z),
    ).tocsr()
    H.sum_duplicates()
    H.data[:] = 1
    return H


def regular_parity_check(
    n_vars: int,
    d_v: int = 3,
    d_c: int = 6,
    seed: int = 0,
    cycle4_passes: int = 30,
) -> sp.csr_matrix:
    """Random regular LDPC matrix with every column degree d_v, row degree d_c."""
    if (n_vars * d_v) % d_c:
        raise ValueError("n_vars * d_v must be divisible by d_c")
    n_checks = n_vars * d_v // d_c
    rng = np.random.default_rng(seed)

    cols = np.repeat(np.arange(n_vars, dtype=np.int64), d_v)
    rows = np.repeat(np.arange(n_checks, dtype=np.int64), d_c)
    rng.shuffle(rows)

    # Repair duplicate (row, col) pairs by pair swaps.
    for _ in range(200):
        key = rows * np.int64(n_vars) + cols
        order = np.argsort(key, kind="stable")
        dup_pos = order[1:][np.diff(key[order]) == 0]
        if dup_pos.size == 0:
            break
        partners = rng.integers(0, rows.size, size=dup_pos.size)
        rows[dup_pos], rows[partners] = rows[partners], rows[dup_pos].copy()

    H = _to_csr(rows, cols, n_checks, n_vars)

    for _ in range(cycle4_passes):
        bad = _break_4cycles(H, rows, cols, rng, n_vars)
        H = _to_csr(rows, cols, n_checks, n_vars)
        if not bad:
            break
    return H


def _to_csr(rows, cols, n_checks, n_vars) -> sp.csr_matrix:
    H = sp.coo_matrix(
        (np.ones(rows.size, dtype=np.int8), (rows, cols)), shape=(n_checks, n_vars)
    ).tocsr()
    H.sum_duplicates()
    H.data[:] = 1
    return H


def _break_4cycles(H, rows, cols, rng, n_vars) -> int:
    """Swap one edge out of each detected 4-cycle; returns #cycles found."""
    gram = (H @ H.T).tocoo()
    mask = (gram.row < gram.col) & (gram.data >= 2)
    bad_pairs = list(zip(gram.row[mask], gram.col[mask]))
    if not bad_pairs:
        return 0
    # Index edges by (row, col) for lookups.
    key = rows * np.int64(n_vars) + cols
    order = np.argsort(key)
    sorted_key = key[order]
    for r1, r2 in bad_pairs:
        shared = np.intersect1d(
            H.indices[H.indptr[r1] : H.indptr[r1 + 1]],
            H.indices[H.indptr[r2] : H.indptr[r2 + 1]],
        )
        if shared.size < 2:
            continue
        c = int(shared[0])
        pos = order[np.searchsorted(sorted_key, np.int64(r2) * n_vars + c)]
        partner = int(rng.integers(0, rows.size))
        rows[pos], rows[partner] = rows[partner], rows[pos]
    # Re-repair duplicates created by the swaps.
    for _ in range(50):
        key = rows * np.int64(n_vars) + cols
        order = np.argsort(key, kind="stable")
        dup_pos = order[1:][np.diff(key[order]) == 0]
        if dup_pos.size == 0:
            break
        partners = rng.integers(0, rows.size, size=dup_pos.size)
        rows[dup_pos], rows[partners] = rows[partners], rows[dup_pos].copy()
    return len(bad_pairs)
