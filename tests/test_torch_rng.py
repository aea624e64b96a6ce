"""The port's per-codeword random planes (``sim/rng.py``).

Philox4x32-10 against the known-answer vectors of its definition (Random123's
``kat_vectors``), the int64 multiply-high against Python integers, and the
property the JAX engine's ``fold_in`` chain gives its counters: a column is a
function of the step key and the global codeword index only, so a plane of
2B codewords is its two B-wide shards side by side, and a Monte-Carlo step
counts what its shards count.
"""

import numpy as np
import pytest
import torch

from informationbottleneckdecodingldpc_torch.construct import DecoderConfig
from informationbottleneckdecodingldpc_torch.decode import DeviceTrellis
from informationbottleneckdecodingldpc_torch.encode import LDPCEncoder
from informationbottleneckdecodingldpc_torch.kernels import philox_planes
from informationbottleneckdecodingldpc_torch.models import get_model
from informationbottleneckdecodingldpc_torch.sim import BERSimulator, rng
from informationbottleneckdecodingldpc_torch.sim.engine import step_seed

CONFIG = "results/configs/wlan_T16_0.8.npz"
M32 = 0xFFFFFFFF
KINDS = ("uniform", "normal", "bits")
KEY = rng.key_words(step_seed(7, 1.2, 3))


@pytest.mark.parametrize(
    "counter, key, want",
    [
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((M32,) * 4, (M32, M32), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        (
            (0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
            (0xA4093822, 0x299F31D0),
            (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1),
        ),
    ],
)
def test_philox_known_answers(counter, key, want):
    assert tuple(int(w) for w in rng.philox4x32(counter, key)) == want


def test_multiply_high_matches_python_ints():
    a = [0, 1, 2**31 - 1, 2**31, M32 - 1, M32]
    a += np.random.default_rng(0).integers(0, 2**32, 2000).tolist()
    for m in rng.PHILOX_M:
        hi, lo = rng.mulhilo32(torch.tensor(a, dtype=torch.int64), m)
        assert hi.tolist() == [(x * m) >> 32 for x in a]
        assert lo.tolist() == [(x * m) & M32 for x in a]


@pytest.mark.parametrize("kind", KINDS)
def test_a_plane_is_its_shards_side_by_side(kind):
    rows, b = 1296, 24
    whole = rng.plane_plain(kind, KEY, rows, 0, 2 * b)
    shards = [rng.plane_plain(kind, KEY, rows, off, b) for off in (0, b)]
    assert whole.dtype == rng.philox_planes.DTYPES[kind] and whole.shape == (rows, 2 * b)
    assert torch.equal(whole, torch.cat(shards, dim=1))
    # Codeword i's column at batch B and 2B, and at any offset.
    assert torch.equal(whole[:, :b], rng.plane_plain(kind, KEY, rows, 0, b))
    assert torch.equal(whole[:, 7], rng.plane_plain(kind, KEY, rows, 7, 1)[:, 0])
    # A shorter column is a prefix of a longer one; other keys and streams differ.
    assert torch.equal(whole[:100], rng.plane_plain(kind, KEY, 100, 0, 2 * b))
    other = rng.plane_plain(kind, rng.key_words(step_seed(7, 1.2, 4)), rows, 0, 2 * b)
    assert not torch.equal(whole, other)


def test_the_counter_layout():
    """Element r of codeword i's uniform column is word r % 4 of the group
    (i, r // 4, stream 2, 0); a bit is bit r % 32 of word (r // 32) % 4 of
    group r // 128 in stream 0."""
    words = torch.stack(rng.philox4x32((torch.arange(8)[None, :], torch.arange(16)[:, None], 2, 0), KEY), 1)
    assert torch.equal(rng.plane_plain("uniform", KEY, 64, 0, 8), rng.uniform24(words).reshape(64, 8))
    bits = rng.plane_plain("bits", KEY, 300, 0, 8)
    w = rng.philox4x32((5, 2, 0, 0), KEY)[1]  # group 2 of codeword 5, word 1
    assert [int(b) for b in bits[256 + 32:256 + 44, 5]] == [(int(w) >> b) & 1 for b in range(12)]
    z = rng.plane_plain("normal", KEY, 64, 0, 8)
    assert torch.isfinite(z).all() and not torch.equal(z[:4], rng.plane_plain("normal", KEY, 4, 1, 8))


def test_moments_of_the_planes():
    rows, batch = 1296, 64  # 82,944 values per plane
    u = rng.plane_plain("uniform", KEY, rows, 0, batch).double()
    assert u.min() >= 0.0 and u.max() < 1.0
    # 5 standard errors: sqrt(1/12 / N) = 0.0010 for the mean of a uniform.
    assert abs(u.mean() - 0.5) < 0.005 and abs(u.var() - 1 / 12) < 0.002
    z = rng.plane_plain("normal", KEY, rows, 0, batch).double()
    # Mean within 5 sqrt(1/N) = 0.017, variance within 5 sqrt(2/N) = 0.025.
    assert abs(z.mean()) < 0.02 and abs(z.var() - 1.0) < 0.03
    assert abs((z**4).mean() - 3.0) < 0.15  # kurtosis of a normal
    bits = rng.plane_plain("bits", KEY, rows, 0, batch).double()
    assert abs(bits.mean() - 0.5) < 0.01


@pytest.fixture(scope="module")
def wlan():
    H = get_model("wlan-1296").make_h()
    return get_model("wlan-1296").make_layout(H), LDPCEncoder(H), DecoderConfig.load(CONFIG)


@pytest.mark.parametrize("decoder, chain", [("ib", "allzero"), ("minsum", "encoded")])
def test_a_step_counts_what_its_shards_count(wlan, decoder, chain):
    layout, enc, cfg = wlan
    b = 8

    def sim(batch):
        kw = dict(max_iters=3)
        if decoder == "ib":
            kw = dict(trellis=DeviceTrellis.from_tables(cfg.tables, "cpu"), max_iters=3,
                      cardinality_t_channel=16)
        s = BERSimulator(layout, decoder, device="cpu", chain=chain, encoder=enc,
                         batch_per_device=batch, batch_tile=4, early_exit=False, **kw)
        s._key = rng.key_words(step_seed(0, 1.0, 5))
        return s

    whole, half = sim(2 * b), sim(b)
    qt, sigma2 = whole.quantizer_for(1.0), whole.sigma2_for(1.0)
    e, f, it = whole._draw_step(qt, sigma2)
    parts = [half._draw_step(qt, sigma2, offset) for offset in (0, b)]
    assert int(e) == sum(int(p[0]) for p in parts) > 0
    assert int(f) == sum(int(p[1]) for p in parts)
    assert float(it) == 2.0 and all(float(p[2]) == 2.0 for p in parts)


def test_draw_runs_the_plain_version_on_the_cpu_and_the_kernel_refuses_it():
    got = rng.draw("uniform", KEY, 100, 3, 5, "cpu")
    assert torch.equal(got, rng.plane_plain("uniform", KEY, 100, 3, 5))
    with pytest.raises(ValueError, match="cuda device"):
        philox_planes.plane("uniform", KEY, 100, 3, 5, "cpu")
    with pytest.raises(ValueError, match="cuda device"):
        rng.draw("normal", KEY, 100, 3, 5, "meta")
    assert sum(philox_planes.launches.values()) == 0
    with pytest.raises(ValueError, match="below 2"):
        rng.draw("bits", KEY, 100, 2**32 - 4, 5, "cpu")
    with pytest.raises(ValueError, match="unknown plane kind"):
        rng.plane_plain("gamma", KEY, 100, 0, 5)
    with pytest.raises(ValueError, match="64-bit"):
        rng.key_words(2**64)
