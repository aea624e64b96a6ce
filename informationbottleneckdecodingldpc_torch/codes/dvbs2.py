"""DVB-S2-style IRA parity-check matrices (N=64800 family).

Two constructors:

- :func:`dvbs2_address_table_parity_check` expands an ETSI EN 302 307 Annex
  B/C address table exactly (q-group rule, 360-bit groups) plus the staircase
  (accumulator) part, producing the true standard matrix when given the
  standard's table. The reference repo loads the equivalent matrix from a
  pre-built, *not committed* ``DVB_S2_0.5.npz``
  (Irregular_LDPC_Decoding/DVB-S2/BER_simulation_OpenCL_enc.py:41), so the
  table itself ships with neither repo.
- :func:`dvbs2_like_parity_check` draws a seeded ensemble-matched stand-in
  with exactly the rate-1/2 DVB-S2 degree profile used by the reference's
  config generation (DVB-S2/decoder_config_generation.py:31-34): variable
  degrees {1:1, 2:32399, 3:19440, 8:12960}, check degrees {6:1, 7:32399}.
  Waterfall-region BER of an ensemble member is statistically equivalent,
  which is what the BER-parity acceptance tests compare.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

# ETSI EN 302 307-1 Annex B, Table B.3: parity-bit accumulator addresses for
# the rate-1/2 N=64800 code (q = 90, 360-bit groups). This is the public
# standard constant the reference consumes in pre-expanded form via its
# (uncommitted) ``DVB_S2_0.5.npz``
# (Irregular_LDPC_Decoding/DVB-S2/BER_simulation_OpenCL_enc.py:41).
# 36 degree-8 information-bit groups followed by 54 degree-3 groups; every
# residue class mod 90 carries exactly 5 addresses, which makes every parity
# check degree exactly 7 after the staircase (6 for check 0) — properties
# asserted in tests/test_codes.py.
DVBS2_R12_N64800_TABLE: tuple[tuple[int, ...], ...] = (
    (54, 9318, 14392, 27561, 26909, 10219, 2534, 8597),
    (55, 7263, 4635, 2530, 28130, 3033, 23830, 3651),
    (56, 24731, 23583, 26036, 17299, 5750, 792, 9169),
    (57, 5811, 26154, 18653, 11551, 15447, 13685, 16264),
    (58, 12610, 11347, 28768, 2792, 3174, 29371, 12997),
    (59, 16789, 16018, 21449, 6165, 21202, 15850, 3186),
    (60, 31016, 21449, 17618, 6213, 12166, 8334, 18212),
    (61, 22836, 14213, 11327, 5896, 718, 11727, 9308),
    (62, 2091, 24941, 29966, 23634, 9013, 15587, 5444),
    (63, 22207, 3983, 16904, 28534, 21415, 27524, 25912),
    (64, 25687, 4501, 22193, 14665, 14798, 16158, 5491),
    (65, 4520, 17094, 23397, 4264, 22370, 16941, 21526),
    (66, 10490, 6182, 32370, 9597, 30841, 25954, 2762),
    (67, 22120, 22865, 29870, 15147, 13668, 14955, 19235),
    (68, 6689, 18408, 18346, 9918, 25746, 5443, 20645),
    (69, 29982, 12529, 13858, 4746, 30370, 10023, 24828),
    (70, 1262, 28032, 29888, 13063, 24033, 21951, 7863),
    (71, 6594, 29642, 31451, 14831, 9509, 9335, 31552),
    (72, 1358, 6454, 16633, 20354, 24598, 624, 5265),
    (73, 19529, 295, 18011, 3080, 13364, 8032, 15323),
    (74, 11981, 1510, 7960, 21462, 9129, 11370, 25741),
    (75, 9276, 29656, 4543, 30699, 20646, 21921, 28050),
    (76, 15975, 25634, 5520, 31119, 13715, 21949, 19605),
    (77, 18688, 4608, 31755, 30165, 13103, 10706, 29224),
    (78, 21514, 23117, 12245, 26035, 31656, 25631, 30699),
    (79, 9674, 24966, 31285, 29908, 17042, 24588, 31857),
    (80, 21856, 27777, 29919, 27000, 14897, 11409, 7122),
    (81, 29773, 23310, 263, 4877, 28622, 20545, 22092),
    (82, 15605, 5651, 21864, 3967, 14419, 22757, 15896),
    (83, 30145, 1759, 10139, 29223, 26086, 10556, 5098),
    (84, 18815, 16575, 2936, 24457, 26738, 6030, 505),
    (85, 30326, 22298, 27562, 20131, 26390, 6247, 24791),
    (86, 928, 29246, 21246, 12400, 15311, 32309, 18608),
    (87, 20314, 6025, 26689, 16302, 2296, 3244, 19613),
    (88, 6237, 11943, 22851, 15642, 23857, 15112, 20947),
    (89, 26403, 25168, 19038, 18384, 8882, 12719, 7093),
    (0, 14567, 24965),
    (1, 3908, 100),
    (2, 10279, 240),
    (3, 24102, 764),
    (4, 12383, 4173),
    (5, 13861, 15918),
    (6, 21327, 1046),
    (7, 5288, 14579),
    (8, 28158, 8069),
    (9, 16583, 11098),
    (10, 16681, 28363),
    (11, 13980, 24725),
    (12, 32169, 17989),
    (13, 10907, 2767),
    (14, 21557, 3818),
    (15, 26676, 12422),
    (16, 7676, 8754),
    (17, 14905, 20232),
    (18, 15719, 24646),
    (19, 31942, 8589),
    (20, 19978, 27197),
    (21, 27060, 15071),
    (22, 6071, 26649),
    (23, 10393, 11176),
    (24, 9597, 13370),
    (25, 7081, 17677),
    (26, 1433, 19513),
    (27, 26925, 9014),
    (28, 19202, 8900),
    (29, 18152, 30647),
    (30, 20803, 1737),
    (31, 11804, 25221),
    (32, 31683, 17783),
    (33, 29694, 9345),
    (34, 12280, 26611),
    (35, 6526, 26122),
    (36, 26165, 11241),
    (37, 7666, 26962),
    (38, 16290, 8480),
    (39, 11774, 10120),
    (40, 30051, 30426),
    (41, 1335, 15424),
    (42, 6865, 17742),
    (43, 31779, 12489),
    (44, 32120, 21001),
    (45, 14508, 6996),
    (46, 979, 25024),
    (47, 4554, 21896),
    (48, 7989, 21777),
    (49, 4972, 20661),
    (50, 6612, 2730),
    (51, 12742, 4418),
    (52, 29194, 595),
    (53, 19267, 20113),
)


def dvbs2_parity_check(rate: str = "1/2", n_ldpc: int = 64800) -> sp.csr_matrix:
    """The true DVB-S2 standard parity-check matrix (ETSI EN 302 307-1).

    Expands the Annex B address table for the requested rate through the
    q-group rule plus the staircase accumulator. Currently rate "1/2"
    (N=64800, K=32400) — the rate the reference simulates
    (Irregular_LDPC_Decoding/DVB-S2/BER_simulation_OpenCL_enc.py:41-73).
    """
    if rate != "1/2" or n_ldpc != 64800:
        raise NotImplementedError(f"no address table for rate {rate}, N={n_ldpc}")
    table = [list(row) for row in DVBS2_R12_N64800_TABLE]
    return dvbs2_address_table_parity_check(table, 64800, 32400)


def _staircase(n_parity: int) -> tuple[np.ndarray, np.ndarray]:
    """Accumulator part: parity column j has entries in rows j and j+1."""
    rows = [np.arange(n_parity, dtype=np.int64)]
    cols = [np.arange(n_parity, dtype=np.int64)]
    rows.append(np.arange(1, n_parity, dtype=np.int64))
    cols.append(np.arange(0, n_parity - 1, dtype=np.int64))
    return np.concatenate(rows), np.concatenate(cols)


def group_size(k_ldpc: int, n_parity: int) -> int:
    """Largest expansion-group size <= 360 dividing both K and N-K (the
    standard uses 360; smaller test codes shrink it)."""
    import math

    g = math.gcd(k_ldpc, n_parity)
    if g <= 360:
        return g
    for cand in range(360, 0, -1):
        if g % cand == 0:
            return cand
    return 1


def dvbs2_address_table_parity_check(
    addresses: list[list[int]], n_ldpc: int, k_ldpc: int, group: int | None = None
) -> sp.csr_matrix:
    """Expand a DVB-S2 parity-address table into H = [A | staircase].

    ``addresses[g]`` lists the parity addresses of the first bit of
    information-bit group ``g`` (360 bits per group); bit ``m`` of the group
    connects to ``(x + (m % 360) * q) % (n_ldpc - k_ldpc)`` for each listed
    ``x``, with ``q = (n_ldpc - k_ldpc) // 360``.
    """
    n_parity = n_ldpc - k_ldpc
    G = group or group_size(k_ldpc, n_parity)
    q = n_parity // G
    rows, cols = [], []
    m = np.arange(G, dtype=np.int64)
    for g, addr in enumerate(addresses):
        col = g * G + m
        for x in addr:
            rows.append((int(x) + m * q) % n_parity)
            cols.append(col)
    sr, sc = _staircase(n_parity)
    rows.append(sr)
    cols.append(sc + k_ldpc)
    r = np.concatenate(rows)
    c = np.concatenate(cols)
    H = sp.coo_matrix(
        (np.ones(r.size, dtype=np.int8), (r, c)), shape=(n_parity, n_ldpc)
    ).tocsr()
    H.sum_duplicates()
    H.data[:] = 1
    return H


def dvbs2_like_address_table(
    n_ldpc: int = 64800, k_ldpc: int = 32400, seed: int = 0
) -> list[list[int]]:
    """Seeded random address table with the exact DVB-S2 rate-1/2 profile.

    Follows the standard's construction discipline exactly (360-bit groups,
    q-strided expansion): the first 36 groups carry 8 addresses (degree-8
    information columns), the remaining 54 groups 3 addresses (degree-3), and
    addresses are balanced so every residue class mod q receives exactly
    ``total/q`` addresses — which makes every parity row's A-degree exactly
    uniform, reproducing the standard's check-degree profile {6: 1, 7: rest}
    after adding the staircase.

    Because the expansion rule is the standard's, H built from the *real*
    ETSI table via :func:`dvbs2_address_table_parity_check` has identical
    structure; this seeded table is an ensemble stand-in (the true table
    ships with neither this repo nor the reference, SURVEY.md §6).
    """
    n_parity = n_ldpc - k_ldpc
    G = group_size(k_ldpc, n_parity)
    q = n_parity // G
    n_groups = k_ldpc // G
    # Degree-8 share: 2/5 of info groups at rate 1/2 (12960 of 32400).
    n_deg8 = int(round(n_groups * 12960 / 32400)) if k_ldpc != 32400 else 36
    group_sizes = [8] * n_deg8 + [3] * (n_groups - n_deg8)
    total = sum(group_sizes)
    if total % q:
        # pad the last degree-3 groups up to divisibility
        i = len(group_sizes) - 1
        while total % q:
            group_sizes[i] += 1
            total += 1
            i -= 1
    per_class = total // q

    rng = np.random.default_rng(seed)
    # Deal residue classes so each appears exactly per_class times, then
    # assign a random multiple-of-q offset per address, avoiding duplicate
    # addresses within a group.
    classes = rng.permutation(np.repeat(np.arange(q, dtype=np.int64), per_class))
    table: list[list[int]] = []
    pos = 0
    for size in group_sizes:
        addrs: set[int] = set()
        for c in classes[pos : pos + size]:
            while True:
                a = int(c) + q * int(rng.integers(0, G))
                if a not in addrs:
                    addrs.add(a)
                    break
        table.append(sorted(addrs))
        pos += size
    return table


def dvbs2_like_parity_check(
    n_ldpc: int = 64800, k_ldpc: int = 32400, seed: int = 0
) -> sp.csr_matrix:
    """Seeded structured IRA code with the DVB-S2 rate-1/2 profile
    (q-group expansion of :func:`dvbs2_like_address_table` + staircase)."""
    table = dvbs2_like_address_table(n_ldpc, k_ldpc, seed)
    return dvbs2_address_table_parity_check(table, n_ldpc, k_ldpc)


def dvbs2_layout_edge_keys(
    H: sp.spmatrix, k_ldpc: int, group: int | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """Per-edge inbox-slot sort keys for q-group IRA codes.

    Every check row in residue class ``c = r mod q`` receives its information
    edges from the *same* set of address entries ``{x : x ≡ c (mod q)}``, so
    sorting each row's inbox by the recovered address
    ``x = (r - (col mod G)·q) mod (N-K)`` gives all rows of a class an
    identical slot-to-address-block assignment — which turns each plane of
    the class-major slot-major layout into whole contiguous runs of the
    CN<->VN permutation. Parity (staircase) edges sort after, subdiagonal
    before diagonal. Returns (csr_key, csc_key) for
    DecodeLayout.from_graph(cn_edge_key=, vn_edge_key=).
    """
    Hr = sp.csr_matrix(H)
    m, n = Hr.shape
    G = group or group_size(k_ldpc, m)
    q = m // G
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(Hr.indptr))
    cols = Hr.indices.astype(np.int64)
    csr_key = np.where(
        cols < k_ldpc,
        (rows - (cols % G) * q) % m,
        m + (cols - k_ldpc - rows) + 1,  # subdiag -> m, diag -> m+1
    )
    Hc = sp.csc_matrix(Hr)
    rows_c = Hc.indices.astype(np.int64)
    cols_c = np.repeat(np.arange(n, dtype=np.int64), np.diff(Hc.indptr))
    csc_key = np.where(
        cols_c < k_ldpc,
        (rows_c - (cols_c % G) * q) % m,
        m + (rows_c - (cols_c - k_ldpc)),  # diag -> m, subdiag -> m+1
    )
    return csr_key, csc_key


def dvbs2_layout_node_keys(n_ldpc: int, k_ldpc: int) -> tuple[np.ndarray, np.ndarray]:
    """Decode-layout node orderings that turn the CN<->VN edge permutation
    into ~360-long contiguous runs.

    Checks and parity variables are ordered class-major: position of row r is
    ``(r % q) * 360 + r // q``. Then every (group, address) block of 360
    edges, and every staircase diagonal, is a contiguous run in both layouts.
    """
    n_parity = n_ldpc - k_ldpc
    G = group_size(k_ldpc, n_parity)
    q = n_parity // G
    r = np.arange(n_parity, dtype=np.int64)
    class_major = (r % q) * G + r // q
    cn_key = class_major
    vn_key = np.concatenate([np.arange(k_ldpc, dtype=np.int64), k_ldpc + class_major])
    return cn_key, vn_key
