"""The port's channel input (``sim/rng.py`` ``channel_input``, the kernel
``csrc/philox_planes.cu`` through ``kernels/philox_planes.py``).

Its plain version against the unfused composition the engine ran before (a
plane, then the quantizer and AWGN operators) for every kind, its consumers
against the JAX package's quantizer functions on the same float32 numpy
planes, a per-thread model of the kernel's 2-D schedule against the planes it
must reproduce, a Monte-Carlo step through the new path against the unfused
composition, the wrapper's refusals, and the benchmark's channel-input
reading's and the roofline's arithmetic for the kernel.
"""

import re
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from informationbottleneckdecodingldpc_tpu.channel import quantizer as jax_quant
from informationbottleneckdecodingldpc_tpu.channel.modulation import bpsk_map as jax_bpsk_map
from informationbottleneckdecodingldpc_torch.channel import (
    build_quantizer_tables,
    device_tables,
    quantize_llr_with,
    quantize_with,
    sample_clusters_from_uniform,
    sample_llrs_from_uniform,
    sigma2_from_ebn0_db,
)
from informationbottleneckdecodingldpc_torch.channel.awgn import received_plane
from informationbottleneckdecodingldpc_torch.construct import DecoderConfig
from informationbottleneckdecodingldpc_torch.decode import DeviceTrellis
from informationbottleneckdecodingldpc_torch.encode import LDPCEncoder
from informationbottleneckdecodingldpc_torch.kernels import philox_planes
from informationbottleneckdecodingldpc_torch.models import get_model
from informationbottleneckdecodingldpc_torch.sim import BERSimulator, rng
from informationbottleneckdecodingldpc_torch.sim.engine import step_seed
from informationbottleneckdecodingldpc_torch.utils import roofline
from ldpc_bench.harness import spec
from ldpc_bench.harness.trace import Event

ROOT = Path(__file__).resolve().parents[1]

FUSED = tuple(philox_planes.FUSED)
KEY = rng.key_words(step_seed(3, 0.8, 11))
ROWS, BATCH = 37, 13  # 37 is no multiple of 2, 4 or 128; 13 no multiple of 4


def _sigma2(ebn0_db: float = 0.8) -> float:
    return float(np.float32(sigma2_from_ebn0_db(ebn0_db, 0.5)))


@pytest.fixture(scope="module", params=[16, 32], ids=["T16", "T32"])
def tables(request):
    sigma2 = _sigma2()
    return device_tables(build_quantizer_tables(sigma2, 3.0, request.param, 2000), "cpu"), sigma2


def _codeword(rows: int, batch: int, seed: int = 1) -> torch.Tensor:
    bits = np.random.default_rng(seed).integers(0, 2, (rows, batch)).astype(np.int8)
    return torch.as_tensor(bits)


def _unfused(kind, qt, sigma2, plane, codeword):
    """What the engine built from a drawn plane before the kernel took it
    over: inversion sampling from a uniform plane, or the received plane
    of a normal one through the quantizer or 2y / sigma^2."""
    if kind.startswith("uniform"):
        zeros = torch.zeros(plane.shape, dtype=torch.int32)
        if kind == "uniform_clusters":
            return sample_clusters_from_uniform(qt.cdf, plane, zeros)
        return sample_llrs_from_uniform(qt.cdf, qt.llrs, plane, zeros)
    bits = torch.zeros(plane.shape, dtype=torch.int8) if codeword is None else codeword
    y = received_plane(bits, plane, sigma2)
    if kind.endswith("clusters"):
        return quantize_with(qt.limits, y)
    if kind.endswith("llrs"):
        return quantize_llr_with(qt.limits, qt.llrs, y)
    return 2.0 * y / sigma2


@pytest.mark.parametrize("offset", [0, 29])
@pytest.mark.parametrize("kind", FUSED)
def test_plain_equals_the_unfused_composition(tables, kind, offset):
    qt, sigma2 = tables
    codeword = _codeword(ROWS, BATCH) if philox_planes.FUSED[kind][2] else None
    got = rng.channel_input_plain(kind, KEY, ROWS, offset, BATCH, qt, sigma2, codeword)
    plane = rng.draw(philox_planes.draw_of(kind), KEY, ROWS, offset, BATCH, "cpu")
    want = _unfused(kind, qt, sigma2, plane, codeword)
    assert got.dtype == want.dtype and got.shape == (ROWS, BATCH)
    assert torch.equal(got, want)
    # The CPU dispatch is the plain version, and a column is its codeword's.
    assert torch.equal(rng.channel_input(kind, KEY, ROWS, offset, BATCH, "cpu", qt, sigma2, codeword), got)
    shard = rng.channel_input_plain(kind, KEY, ROWS, offset + 4, 5, qt, sigma2,
                                    None if codeword is None else codeword[:, 4:9].contiguous())
    assert torch.equal(shard, got[:, 4:9])


@pytest.mark.parametrize("offset", [0, 29])
def test_info_bits_are_the_bits_plane(offset):
    rows = 300  # two whole groups of 128 bits and a part of a third
    got = rng.draw("bits", KEY, rows, offset, BATCH, "cpu")
    assert got.dtype == torch.int8 and torch.equal(got, rng.plane_plain("bits", KEY, rows, offset, BATCH))


def _jax_y(codeword: np.ndarray, noise: np.ndarray, sigma2: float) -> np.ndarray:
    return np.asarray(jax.jit(lambda b, n, s: jax_bpsk_map(b) + jnp.sqrt(s) * n)(
        jnp.asarray(codeword), jnp.asarray(noise), jnp.float32(sigma2)))


@pytest.mark.parametrize("consumer", ["clusters", "llrs"])
def test_uniform_consumers_equal_jax(tables, consumer):
    qt, _ = tables
    u = np.random.default_rng(5).random((96, 40), dtype=np.float32)
    got = rng.consume(f"uniform_{consumer}", torch.as_tensor(u), qt)
    zeros = jnp.zeros(u.shape, jnp.int32)
    cdf = jnp.asarray(qt.cdf.numpy())
    if consumer == "clusters":
        want = jax_quant.sample_clusters_from_uniform(cdf, jnp.asarray(u), zeros)
    else:
        want = jax_quant.sample_llrs_from_uniform(cdf, jnp.asarray(qt.llrs.numpy()), jnp.asarray(u), zeros)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("consumer", ["clusters", "llrs"])
def test_encoded_consumers_equal_jax(tables, consumer):
    """The AWGN value within one ULP of the larger of |y| and |sqrt(s2) n|
    (XLA on the CPU fuses the multiply and the add into one FMA), and the
    cluster or its LLR equal wherever no y lies within that ULP of a limit."""
    qt, sigma2 = tables
    rows, batch = 96, 40
    c = _codeword(rows, batch, seed=6)
    noise = np.random.default_rng(7).standard_normal((rows, batch), dtype=np.float32)
    y = received_plane(c, torch.as_tensor(noise), sigma2).numpy()
    jy = _jax_y(c.numpy(), noise, sigma2)
    product = np.abs(np.float32(np.sqrt(sigma2)) * noise)
    ulp = np.spacing(np.maximum(np.abs(jy), product))
    assert np.all(np.abs(y - jy) <= ulp)
    got = rng.consume(f"encoded_{consumer}", torch.as_tensor(noise), qt, sigma2, c).numpy()
    limits = jnp.asarray(qt.limits.numpy())
    if consumer == "clusters":
        want = np.asarray(jax_quant.quantize_with(limits, jnp.asarray(jy)))
    else:
        want = np.asarray(jax_quant.quantize_llr_with(limits, jnp.asarray(qt.llrs.numpy()), jnp.asarray(jy)))
    clear = (np.abs(y[..., None] - qt.limits.numpy()[1:]) > ulp[..., None]).all(-1)
    assert clear.mean() > 0.99
    assert np.array_equal(got[clear], want[clear])


# -- the kernel's schedule, modelled thread by thread ------------------------


def count_below(thresholds: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The kernel's branch-free binary search over :data:`philox_planes.SLOTS`
    slots (the thresholds, then +inf): five probes at t + step - 1."""
    slots = torch.full((philox_planes.SLOTS,), float("inf"))
    slots[: thresholds.numel()] = thresholds
    t = torch.zeros(x.shape, dtype=torch.int64)
    step = philox_planes.SLOTS // 2
    while step:
        t += torch.where(slots[t + step - 1] < x, step, 0)
        step //= 2
    return t.to(torch.int32)


# The kernel's schedule (csrc/philox_planes.cu): kCols adjacent codeword
# columns a thread, blocks of kBlockX column quads x kBlockY group rows, at
# most kMaxGridY group-row blocks.
COLUMNS, BLOCK_X, BLOCK_Y, MAX_GRID_Y = 4, 64, 4, 65535


def launch_grid(kind, rows, batch, max_grid_y=MAX_GRID_Y):
    """(column-quad blocks, group-row blocks) of the grid the C launcher
    derives for a [rows, batch] output of ``kind``."""
    per = philox_planes.ELEMENTS_PER_GROUP[philox_planes.draw_of(kind)]
    quads, groups = -(-batch // COLUMNS), -(-rows // per)
    return -(-quads // BLOCK_X), min(-(-groups // BLOCK_Y), max_grid_y)


def kernel_model(kind, key, rows, offset, batch, qt=None, sigma2=None, codeword=None,
                 max_grid_y=MAX_GRID_Y):
    """The output of ``kind`` as the kernel's threads write it: thread
    (bx, tx) x (by, ty) of the :func:`launch_grid` grid takes the column quad
    i0 = 4 (bx BLOCK_X + tx) and the group rows by BLOCK_Y + ty, then every
    grid-rows stride of groups; it draws the four columns' Philox groups and
    writes their rows and columns inside the plane. Returns the output and
    the times each element was written."""
    draw = philox_planes.draw_of(kind)
    consumer = philox_planes.FUSED[kind][1] if kind in philox_planes.FUSED else "plane"
    per = philox_planes.ELEMENTS_PER_GROUP[draw]
    gx, gy = launch_grid(kind, rows, batch, max_grid_y)
    bx, by, cols = BLOCK_X, BLOCK_Y, COLUMNS
    groups = -(-rows // per)
    quads = [(x * bx + tx) * cols for x in range(gx) for tx in range(bx)]
    firsts = [y * by + ty for y in range(gy) for ty in range(by)]
    trips = [(i0, g) for i0 in quads if i0 < batch
             for g0 in firsts for g in range(g0, groups, gy * by)]
    i0, g = (torch.tensor(v, dtype=torch.int64) for v in zip(*trips))
    col = i0[:, None] + torch.arange(cols)  # [trips, 4]
    grp = g[:, None].expand_as(col)
    words = rng.philox4x32((offset + col, grp, philox_planes.STREAMS[draw], 0), key)
    if draw == "uniform":
        values = [rng.uniform24(w) for w in words]
    elif draw == "normal":
        values = []
        for e in range(2):
            u1 = ((words[2 * e] >> 8) + 1).to(torch.float32) * rng.U24
            u2 = rng.uniform24(words[2 * e + 1])
            values.append(torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(rng.TWO_PI * u2))
    else:
        values = [((words[b // 32] >> (b % 32)) & 1).to(torch.int8) for b in range(128)]
    dtype = {"plane": philox_planes.DTYPES[draw], "clusters": torch.int32}.get(consumer, torch.float32)
    out = torch.zeros((rows, batch), dtype=dtype)
    hits = torch.zeros((rows, batch), dtype=torch.int64)
    live = col < batch
    for e, x in enumerate(values):
        row = grp * per + e
        keep = live & (row < rows)
        r, c, x = row[keep], col[keep], x[keep]
        if draw == "normal" and consumer != "plane":
            bit = torch.zeros_like(r, dtype=torch.int8) if codeword is None else codeword[r, c]
            s = float(np.float32(np.sqrt(sigma2)))
            x = (1.0 - 2.0 * bit.to(torch.float32)) + s * x  # y
        if consumer == "true":
            x = (2.0 * x) * float(np.float32(1.0) / np.float32(sigma2))
        elif consumer in ("clusters", "llrs"):
            thresholds = qt.cdf[1:-1] if draw == "uniform" else qt.limits[1:]
            x = count_below(thresholds, x)
            if consumer == "llrs":
                x = qt.llrs[x.long()]
        out[r, c] = x.to(dtype)
        hits[r, c] += 1
    return out, hits


@pytest.mark.parametrize("shape", [(37, 13), (64, 8), (300, 5), (5, 260)], ids=str)
@pytest.mark.parametrize("kind", ["uniform", "normal", "bits"])
def test_the_schedule_covers_each_element_once_and_draws_the_plane(kind, shape):
    rows, batch = shape
    got, hits = kernel_model(kind, KEY, rows, 7, batch)
    assert bool((hits == 1).all())
    assert torch.equal(got, rng.plane_plain(kind, KEY, rows, 7, batch))


@pytest.mark.parametrize("kind", FUSED)
def test_the_schedule_reproduces_the_channel_input(tables, kind):
    """Every fused kind; the grid cut to 2 group-row blocks so that threads
    stride over the group rows. The true LLRs are held to the composition as
    torch computes it on a card: its division by a Python scalar multiplies
    by the float32 reciprocal."""
    qt, sigma2 = tables
    rows, batch = 75, 14
    codeword = _codeword(rows, batch, seed=8) if philox_planes.FUSED[kind][2] else None
    got, hits = kernel_model(kind, KEY, rows, 3, batch, qt, sigma2, codeword, max_grid_y=2)
    assert launch_grid(kind, rows, batch, 2)[1] == 2 and bool((hits == 1).all())
    want = rng.channel_input_plain(kind, KEY, rows, 3, batch, qt, sigma2, codeword)
    if kind.endswith("true"):
        bits = torch.zeros((rows, batch), dtype=torch.int8) if codeword is None else codeword
        y = received_plane(bits, rng.plane_plain("normal", KEY, rows, 3, batch), sigma2)
        card = (2.0 * y) * float(np.float32(1.0) / np.float32(sigma2))
        assert torch.equal(got, card)
        # The reciprocal's rounding and the product's: within two float32 epsilons.
        assert bool(((got - want).abs() <= 2 * torch.finfo(torch.float32).eps * want.abs()).all())
    else:
        assert torch.equal(got, want)


def test_the_search_is_searchsorted_on_ascending_tables():
    gen = np.random.default_rng(9)
    for n in (1, 15, 31):
        thresholds = torch.as_tensor(np.sort(gen.normal(size=n)).astype(np.float32))
        thresholds[n // 2:n // 2 + 2] = thresholds[n // 2]  # a repeated threshold
        x = torch.as_tensor(np.concatenate([gen.normal(size=500), thresholds.numpy()]).astype(np.float32))
        want = torch.searchsorted(thresholds, x, out_int32=True)
        assert torch.equal(count_below(thresholds, x), want)


def test_launch_grid():
    assert launch_grid("uniform_clusters", 1296, 4096) == (16, 81)
    assert launch_grid("encoded_clusters", 64800, 1024) == (4, 8100)
    assert launch_grid("bits", 32400, 1024) == (4, 64)
    assert launch_grid("normal", 10**6, 5) == (1, MAX_GRID_Y)
    source = (ROOT / "informationbottleneckdecodingldpc_torch/csrc/philox_planes.cu").read_text()
    for name, value in (("kCols", COLUMNS), ("kBlockX", BLOCK_X), ("kBlockY", BLOCK_Y),
                        ("kMaxGridY", MAX_GRID_Y)):
        assert re.search(rf"\b{name} = {value}\b", source), name


# -- the engine ------------------------------------------------------------------------


@pytest.fixture(scope="module")
def wlan():
    H = get_model("wlan-1296").make_h()
    cfg = DecoderConfig.load("results/configs/wlan_T16_0.8.npz")
    return get_model("wlan-1296").make_layout(H), LDPCEncoder(H), cfg


@pytest.mark.parametrize("decoder, chain, llr_source", [
    ("ib", "allzero", "quantized"),
    ("minsum", "allzero", "true"),
    ("minsum", "allzero", "quantized"),
    ("ib", "encoded", "quantized"),
    ("minsum", "encoded", "quantized"),
    ("bp", "encoded", "true"),
])
def test_a_step_counts_what_the_unfused_composition_counts(wlan, decoder, chain, llr_source):
    layout, enc, cfg = wlan
    kw = dict(max_iters=4)
    if decoder == "ib":
        kw = dict(trellis=DeviceTrellis.from_tables(cfg.tables, "cpu"), max_iters=4,
                  cardinality_t_channel=16)
    sim = BERSimulator(layout, decoder, device="cpu", chain=chain, llr_source=llr_source,
                       encoder=enc, batch_per_device=8, batch_tile=4, **kw)
    sim._key = rng.key_words(step_seed(0, 1.0, 2))
    ebn0 = 1.0 if decoder == "ib" else 1.6
    qt, sigma2 = sim.quantizer_for(ebn0), sim.sigma2_for(ebn0)
    got = sim._draw_step(qt, sigma2, offset=16)

    def draw(kind, rows):
        return rng.draw(kind, sim._key, rows, 16, 8, "cpu")

    n = layout.n_vars
    consumer = "clusters" if decoder == "ib" else "llrs" if llr_source == "quantized" else "true"
    if chain == "encoded":
        codeword = sim._encode(draw("bits", enc.k))
        kind, plane = f"encoded_{consumer}", draw("normal", n)
    elif llr_source == "true":
        codeword, kind, plane = None, "normal_true", draw("normal", n)
    else:
        codeword, kind, plane = None, f"uniform_{consumer}", draw("uniform", n)
    assert sim.channel_input_kind == kind
    want = sim.decode_and_count(_unfused(kind, qt, sigma2, plane, codeword), codeword)
    assert [float(v) for v in got] == [float(v) for v in want]
    assert int(got[0]) > 0


def test_the_wrapper_refuses_what_the_kernel_does_not_take(tables):
    qt, sigma2 = tables
    with pytest.raises(ValueError, match="cuda device"):
        philox_planes.channel_input("uniform_clusters", KEY, 10, 0, 4, "cpu", qt)
    with pytest.raises(ValueError, match="cuda device"):
        rng.channel_input("encoded_llrs", KEY, 10, 0, 4, "meta", qt, sigma2, _codeword(10, 4))
    assert sum(philox_planes.launches.values()) == 0
    with pytest.raises(ValueError, match="unknown channel input"):
        rng.channel_input("uniform", KEY, 10, 0, 4, "cpu", qt)
    with pytest.raises(ValueError, match="reads"):
        rng.channel_input_plain("encoded_true", KEY, 10, 0, 4, qt, sigma2)
    with pytest.raises(ValueError, match="below 2"):
        rng.channel_input("uniform_llrs", KEY, 10, 2**32 - 2, 4, "meta", qt)


def test_the_profile_times_each_step_between_its_first_draw_and_its_decode():
    """The benchmark's ``channel_input.ms_per_step`` on two encoded steps,
    shuffled: the bits plane, the encoder and the channel input of each
    count; the decode passes, the counting after them and a kernel before
    the first draw do not."""
    kernels = [
        ("fill", -10, 7.0),
        ("void (anonymous namespace)::channel_input_kernel<0, 0, false, true>(Args)", 0, 5.0),
        ("sm90_gemm", 6, 100.0), ("channel_input_kernel<1, 1, true, true>", 110, 30.0),
        ("ib_lut_fused_kernel", 150, 2000.0), ("reduce", 2200, 3.0),
        ("channel_input_kernel<0, 0, false, true>", 2300, 5.0), ("sm90_gemm", 2310, 95.0),
        ("channel_input_kernel<1, 1, true, true>", 2400, 30.0), ("cn_kernel", 2500, 10.0),
        ("vn_kernel", 2510, 10.0), ("reduce", 2520, 3.0),
    ]
    metric = spec.metric("channel_input.ms_per_step")

    def read(kernels, steps):
        device = [Event(name, start, start + us) for name, start, us in kernels]
        return metric.read(types.SimpleNamespace(device=device, steps=steps, reader=spec.metric))

    got = read(kernels[::-1], steps=2)
    assert got == pytest.approx((5 + 100 + 30 + 5 + 95 + 30) / 2 / 1e3)
    assert read(kernels[:4], steps=1) is None  # no decode kernel: not measured


def test_pipe_counts_of_sass_opcodes():
    got = roofline.pipe_counts({"IMAD": 4, "LOP3": 3, "FFMA": 2, "FSETP": 1, "FSEL": 2, "MUFU": 1,
                                "I2FP": 2, "LDS": 5})
    # Add, multiply and FMA at 128 per SM and clock; compare, min, max and
    # select at 64; conversions at 16; integer instructions only in issue.
    assert got == {"fp32": 2, "compare": 3, "sfu": 1, "conversion": 2, "lookup": 5}
    assert set(got) <= set(roofline.DATA_SHEET_OPS_PER_S)
    assert roofline.sass_counts({"IMAD": 4, "FFMA": 2}) == {"fp32": 2, "issue": 6}
    b = roofline.bound(0, {"int32": roofline.DATA_SHEET_OPS_PER_S["int32"] / 1e3})
    assert b["bound_ms"] == pytest.approx(1.0) and b["bound_by"] == "operations"
    assert b["busiest"] == "int32"


@pytest.mark.parametrize("kind, thresholds, per_element", [
    ("bits", 0, {"int32": 40 / 128, "logic": 20 / 128}),
    ("uniform", 0, {"int32": 10, "logic": 5, "conversion": 1, "fp32": 1}),
    ("normal", 0, {"int32": 20, "logic": 10, "fp32": 40, "sfu": 3}),
    ("uniform_clusters", 15, {"int32": 10, "logic": 5, "conversion": 1, "fp32": 1, "compare": 4,
                              "lookup": 4}),
    ("uniform_llrs", 31, {"int32": 10, "logic": 5, "conversion": 1, "fp32": 1, "compare": 5,
                          "lookup": 6}),
    ("normal_true", 0, {"int32": 20, "logic": 10, "fp32": 40 + 2 + 2, "sfu": 3}),
    ("encoded_clusters", 15, {"int32": 20, "logic": 10, "fp32": 40 + 2, "compare": 4, "sfu": 3,
                              "lookup": 4}),
    ("encoded_llrs", 15, {"int32": 20, "logic": 10, "fp32": 40 + 2, "compare": 4, "sfu": 3,
                          "lookup": 5}),
    ("encoded_true", 0, {"int32": 20, "logic": 10, "fp32": 40 + 2 + 2, "sfu": 3}),
])
def test_channel_input_ops(kind, thresholds, per_element):
    """The operations an output needs: Philox per group, Box-Muller (here 40
    FP32 and 3 SFU instructions a normal) per normal, log2(T) probes a
    search; on a shape whose rows fill whole groups."""
    rows, batch = 256, 6
    got = roofline.channel_input_ops(kind, rows, batch, {"fp32": 40, "sfu": 3}, thresholds)
    assert got == pytest.approx({k: n * rows * batch for k, n in per_element.items()})
    assert set(got) <= set(roofline.DATA_SHEET_OPS_PER_S)
    # A ragged column draws its last group whole.
    assert roofline.channel_input_ops(kind, rows - 1, batch, {"fp32": 40, "sfu": 3},
                                      thresholds)["int32"] == got["int32"]
