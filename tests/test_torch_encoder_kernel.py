"""The encoded chain's encoder kernel (``csrc/encoder.cu``) on the CPU.

The wrapper ``kernels/encoder.py`` ``DeviceEncoder`` runs its plain version
for a CPU tensor: it is held equal to the host ``LDPCEncoder.encode`` on a
staircase code (DVB-S2-like), WLAN (dense B^-1) and a code with a
triangular, non-staircase B at ragged batches. Numpy models of the kernel's
two algorithms are held equal to the plain version: the staircase path's
chunked scan (each thread's rows, a scan of the thread rows' totals, the
block's carry by decoupled look-back, which may stop at any published
prefix) at several chunk sizes and on column words of any width (XOR acts on
each byte alike, so the kernel's 16- and 1-byte words scan as these do), and
the dense path's
AND-popcount product over B^-1 packed as the wrapper packs it, its rows
split over blocks. The kernel itself is held equal to the plain version on
the card by ``chip_smoke.py`` (phase 40).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from informationbottleneckdecodingldpc_torch.codes import dvbs2_like_parity_check
from informationbottleneckdecodingldpc_torch.encode import LDPCEncoder, device_encoder
from informationbottleneckdecodingldpc_torch.kernels import encoder as kernel
from informationbottleneckdecodingldpc_torch.models import get_model

CODES = ("dvbs2-like-6480", "wlan-1296", "lower-600")
BATCHES = (1, 7, 200)


def _lower_code(k: int, m: int, seed: int) -> sp.csr_matrix:
    """H = [A | B] with B lower triangular (unit diagonal and subdiagonal
    and a few entries below them), so not a staircase: the dense path."""
    rng = np.random.default_rng(seed)
    A = rng.random((m, k)) < 5.0 / k
    B = np.eye(m, dtype=bool) | np.eye(m, k=-1, dtype=bool)
    B |= np.tril(rng.random((m, m)) < 2.0 / m, -2)
    return sp.csr_matrix(np.hstack([A, B]).astype(np.uint8))


@pytest.fixture(scope="module")
def encoders():
    return {
        "dvbs2-like-6480": LDPCEncoder(dvbs2_like_parity_check(6480, 3240, seed=2)),
        "wlan-1296": LDPCEncoder(get_model("wlan-1296").make_h()),
        "lower-600": LDPCEncoder(_lower_code(600, 600, seed=4)),
    }


def _info(enc, batch: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 2, (enc.k, batch)).astype(np.int8)


def _syndromes(dev, info: np.ndarray) -> np.ndarray:
    """s = A u over GF(2), [m, batch], as the kernel gathers it: each check's
    info columns in quads of the wrapper's table, -1 skipped."""
    table = dev._table.numpy()
    s = np.zeros((table.shape[0], info.shape[1]), dtype=info.dtype)
    for quad in range(table.shape[1] // 4):
        for col in table[:, 4 * quad : 4 * quad + 4].T:
            s[col >= 0] ^= info[col[col >= 0]]
    return s


def test_column_table_holds_each_check_once(encoders):
    """The kernel's table: A's columns of each check in its row, padded with
    -1 to a multiple of 4."""
    for enc in encoders.values():
        table = device_encoder(enc, "cpu")._table.numpy()
        A = sp.csr_matrix(enc.H[:, : enc.k])
        assert table.dtype == np.int32 and table.shape[1] % 4 == 0 and table.shape[1] - 4 < np.diff(A.indptr).max()
        for r in range(0, enc.n - enc.k, 7):
            row = table[r][table[r] >= 0]
            assert sorted(row) == sorted(A.indices[A.indptr[r] : A.indptr[r + 1]])
            assert (table[r][len(row):] == -1).all()


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("code", CODES)
def test_wrapper_on_cpu_runs_plain_and_equals_host_encoder(encoders, code, batch):
    enc = encoders[code]
    dev = device_encoder(enc, "cpu")
    assert dev.is_staircase == (code == "dvbs2-like-6480")
    info = _info(enc, batch, batch)
    got = dev(torch.as_tensor(info))
    assert got.dtype == torch.int8 and tuple(got.shape) == (enc.n, batch)
    assert np.array_equal(got.numpy(), enc.encode(info))
    assert torch.equal(dev.plain(torch.as_tensor(info)), got)
    assert dev.launches == 0  # the plain version launches nothing


@pytest.mark.parametrize("code", CODES)
def test_plain_tables_are_made_at_the_plain_versions_first_call(encoders, code):
    """The kernel's tables are made at once; the plain version's (its
    slot-major columns and B^-1 in float32) only when it first runs, and
    then kept."""
    enc = encoders[code]
    dev = device_encoder(enc, "cpu")
    assert dev._plain_tables is None
    dev(torch.as_tensor(_info(enc, 3, 0)))
    cols, inverse = dev._plain_tables
    A = sp.csr_matrix(enc.H[:, : enc.k])
    assert tuple(cols.shape) == (np.diff(A.indptr).max(), enc.n - enc.k) and cols.dtype == torch.int64
    assert (inverse is None) == dev.is_staircase
    if inverse is not None:
        assert inverse.dtype == torch.float32 and np.array_equal(inverse.numpy(), dev._inverse)
    dev(torch.as_tensor(_info(enc, 3, 1)))
    assert dev._plain_tables[0] is cols


@pytest.mark.parametrize("name", ["regular-3-6-504", "regular-3-6-8000"])
def test_zoo_regular_codes_have_no_encoder(name):
    """The zoo's regular codes have a singular B, so no encoded chain (and no
    device encoder) runs on them; the streamed dense path is held on the
    card with a random B^-1 of 4000 rows instead."""
    with pytest.raises(ValueError, match="singular"):
        LDPCEncoder(get_model(name).make_h())


def staircase_model(s: np.ndarray, rows_per_thread: int, thread_rows: int, rng) -> np.ndarray:
    """The staircase kernel's scan of s [m, words] (any unsigned word type):
    each thread's running XOR over its rows, the thread rows' totals scanned
    in the block, and the block's carry by look-back, which XORs the
    aggregates of the blocks above it until it meets one whose inclusive
    prefix is published (drawn at random; chunk 0 publishes its prefix at
    once)."""
    m, words = s.shape
    per_block = rows_per_thread * thread_rows
    chunks = -(-m // per_block)
    pad = np.zeros((chunks * per_block, words), dtype=s.dtype)
    pad[:m] = s
    local = np.bitwise_xor.accumulate(pad.reshape(chunks, thread_rows, rows_per_thread, words), axis=2)
    totals = local[:, :, -1]
    below = np.bitwise_xor.accumulate(totals, axis=1) ^ totals  # exclusive, over thread rows
    agg = np.bitwise_xor.reduce(totals, axis=1)
    inc = np.bitwise_xor.accumulate(agg, axis=0)
    carry = np.zeros_like(agg)
    for j in range(1, chunks):
        q = j - 1
        while q > 0 and rng.random() < 0.6:  # q's prefix not yet seen: take its aggregate
            carry[j] ^= agg[q]
            q -= 1
        carry[j] ^= inc[q]
    out = local ^ below[:, :, None] ^ carry[:, None, None]
    return out.reshape(-1, words)[:m]


@pytest.mark.parametrize("word", [np.uint8, np.uint32, np.uint64])
@pytest.mark.parametrize("rows_per_thread,thread_rows", [(8, 32), (8, 8), (4, 10), (7, 3), (1, 1)])
def test_staircase_scan_model_equals_plain(encoders, rows_per_thread, thread_rows, word):
    """Chunks of 256, 64, 40, 21 and 1 rows over m = 3240 (256, 64 and 21
    leave a ragged last chunk), on column words of 1, 4 and 8 bytes."""
    enc = encoders["dvbs2-like-6480"]
    dev = device_encoder(enc, "cpu")
    info = _info(enc, 200, 11)
    want = dev.plain(torch.as_tensor(info)).numpy()
    s = _syndromes(dev, info.view(np.uint8).view(word))
    rng = np.random.default_rng(rows_per_thread * 100 + thread_rows)
    parity = staircase_model(s, rows_per_thread, thread_rows, rng).view(np.int8)
    assert np.array_equal(np.concatenate([info, parity]), want)


def dense_model(info: np.ndarray, s: np.ndarray, packed: np.ndarray, splits: int) -> np.ndarray:
    """The dense kernel on groups of 32 codewords: s [m, batch] bit-packed
    per codeword (bit b of word w = s[32 w + b]), each parity row the parity
    of the popcount of the XOR over the row's words of (row AND s), the rows
    split over ``splits`` blocks of ceil(m / splits); every row is computed
    once."""
    m, batch = s.shape
    stride = packed.shape[1]
    bits = np.zeros((stride * 32, batch), dtype=np.uint64)
    bits[:m] = s
    sw = (bits.reshape(stride, 32, batch) << np.arange(32, dtype=np.uint64)[None, :, None]).sum(
        axis=1).astype(np.uint32)  # [stride, batch]
    parity = np.full((m, batch), -1, dtype=np.int8)
    per = -(-m // splits)
    for y in range(splits):
        for i in range(y * per, min(m, (y + 1) * per)):
            assert parity[i, 0] == -1
            acc = np.bitwise_xor.reduce(packed[i][:, None] & sw, axis=0)
            for shift in (16, 8, 4, 2, 1):
                acc ^= acc >> np.uint32(shift)
            parity[i] = (acc & 1).astype(np.int8)
    return np.concatenate([info, parity])


@pytest.mark.parametrize("splits", [1, 3, 7])
@pytest.mark.parametrize("code", ["wlan-1296", "lower-600"])
def test_dense_product_model_equals_plain(encoders, code, splits):
    enc = encoders[code]
    dev = device_encoder(enc, "cpu")
    info = _info(enc, 75, 12)
    packed = kernel.pack_rows(dev._inverse)
    got = dense_model(info, _syndromes(dev, info), packed, splits)
    assert np.array_equal(got, dev.plain(torch.as_tensor(info)).numpy())


@pytest.mark.parametrize("n", [1, 31, 32, 648, 4000])
def test_pack_rows_layout(n):
    rows = np.random.default_rng(n).integers(0, 2, (5, n)).astype(np.uint8)
    packed = kernel.pack_rows(rows)
    assert packed.dtype == np.uint32 and packed.shape == (5, -(-n // 128) * 4)
    bit = lambda i, c: (int(packed[i, c // 32]) >> (c % 32)) & 1
    assert all(bit(i, c) == rows[i, c] for i in range(5) for c in range(n))
    assert all(bit(i, c) == 0 for i in range(5) for c in range(n, packed.shape[1] * 32))


def test_dense_splits():
    """Two blocks an SM where the batch allows, at least 128 rows a block."""
    assert kernel.dense_splits(648, 512, 132) == 6  # wlan_ib.queue_enc512
    assert kernel.dense_splits(648, 4096, 132) == 3
    assert kernel.dense_splits(4000, 512, 132) == 17
    assert kernel.dense_splits(648, 2**20, 132) == 1
    assert kernel.dense_splits(100, 1, 132) == 1
