"""The headline throughput scenario, the float decoders' and DVB-S2
scenarios, the benchmark matrix, and their timing.

Port of ``utils/benchmarks.py``: WLAN 802.11n N=1296 R=1/2, the irregular IB
decoder with message alignment (|T|=16, i_max=50, checked-in config
``results/configs/wlan_T16_0.8.npz``), the fused kernel, all-zeros chain at
0.8 dB, batch 4096 x 8 Monte-Carlo steps per dispatch. Metric: decoded coded
bits/s per device, the median of timed dispatches after one warm-up.

``FLOAT_SCENARIOS`` are the benchmark matrix's float cells on the same code
(``scripts/bench_matrix.py`` ``wlan_minsum`` and ``wlan_bp_quant``):
min-sum and BP on 16-level quantized LLRs, all-zeros chain at 2.0 dB,
i_max 50, batch 4096 x 8 steps.

``DVBS2_SCENARIOS`` are the matrix's DVB-S2 R=1/2 N=64800 cells
(``scripts/bench_matrix.py`` ``dvbs2_ib_hbm_encoded`` and ``dvbs2_minsum``):
the IB decoder with config ``dvbs2_T16_0.6`` on the encoded chain through the
device-memory kernel K3, and min-sum on 16-level quantized LLRs on the
all-zeros chain (K4 through ``backend='auto'``), both at 1.0 dB, i_max 50,
counting the info bits, batch 1024 x 1 step per dispatch (the JAX matrix
used 128 for the TPU's VMEM; a card holds 1024: K4's float views are 1.86 GB).

``MATRIX`` are the 12 cells of ``scripts/bench_matrix.py:318-350`` with
their names, models, decoders, chains, backends, SNRs and batches, run by
``cli/bench_matrix.py``: unset keys take the JAX script's defaults (chain
``allzero``, backend ``auto``, batch 512 x 4 steps, the model's design Eb/N0
and decode i_max). The DVB-S2 cells run at batch 1024, as ``DVBS2_SCENARIOS``
do; the all-zeros cells of the regular code count every bit.
"""

from __future__ import annotations

import statistics
import time
from pathlib import Path

import torch

HEADLINE = dict(
    model="wlan-1296",
    config="wlan_T16_0.8",
    decoder="ib",
    backend="fused",
    chain="allzero",
    batch=4096,
    steps_per_dispatch=8,
    ebn0_db=0.8,
)

FLOAT_SCENARIOS = {
    name: dict(
        model="wlan-1296",
        decoder=decoder,
        chain="allzero",
        llr_source="quantized",
        count_all_bits=False,
        batch=4096,
        steps_per_dispatch=8,
        max_iters=50,
        ebn0_db=2.0,
        seed=0,
    )
    for name, decoder in (("wlan_minsum", "minsum"), ("wlan_bp_quant", "bp"))
}

DVBS2_SCENARIOS = {
    "dvbs2_ib_hbm_encoded": dict(
        model="dvbs2-64800",
        decoder="ib",
        config="dvbs2_T16_0.6",
        chain="encoded",
        backend="hbm",
        batch=1024,
        steps_per_dispatch=1,
        ebn0_db=1.0,
        seed=0,
    ),
    "dvbs2_minsum": dict(
        model="dvbs2-64800",
        decoder="minsum",
        chain="allzero",
        llr_source="quantized",
        backend="auto",
        batch=1024,
        steps_per_dispatch=1,
        max_iters=50,
        ebn0_db=1.0,
        seed=0,
    ),
}

_WLAN_IB = dict(model="wlan-1296", decoder="ib", config="wlan_T16_0.8")
MATRIX = {
    "wlan_ib_fused": dict(_WLAN_IB, backend="fused", batch=4096, steps=8),
    "wlan_ib_xla": dict(_WLAN_IB, backend="xla", batch=2048),
    "wlan_ib_fused_encoded": dict(
        _WLAN_IB, chain="encoded", backend="fused", batch=4096, steps=8
    ),
    "wlan_ib_fused_highsnr": dict(_WLAN_IB, backend="fused", batch=2048, ebn0=2.4),
    "wlan_minsum": dict(
        model="wlan-1296", decoder="minsum", batch=4096, steps=8, max_iters=50, ebn0=2.0
    ),
    "wlan_bp_quant": dict(
        model="wlan-1296", decoder="bp", batch=4096, steps=8, max_iters=50, ebn0=2.0
    ),
    "wlan_T32_ib_fused": dict(
        model="wlan-1296-T32", decoder="ib", config="wlan_T32_0.6", backend="fused",
        batch=2048, steps=8,
    ),
    "regular8000_ib_fused": dict(
        model="regular-3-6-8000", decoder="ib", config="regular_T16_1.05",
        backend="fused", batch=512, ebn0=1.05,
    ),
    "regular8000_minsum": dict(
        model="regular-3-6-8000", decoder="minsum", batch=1024, steps=4, max_iters=50,
        ebn0=2.0,
    ),
    "dvbs2_ib_hbm_encoded": dict(
        model="dvbs2-64800", decoder="ib", chain="encoded", config="dvbs2_T16_0.6",
        backend="hbm", batch=1024, steps=1, ebn0=1.0,
    ),
    "dvbs2_ib_xla_encoded": dict(
        model="dvbs2-64800", decoder="ib", chain="encoded", config="dvbs2_T16_0.6",
        backend="xla", batch=1024, steps=1, ebn0=1.0,
    ),
    "dvbs2_minsum": dict(
        model="dvbs2-64800", decoder="minsum", batch=1024, steps=1, max_iters=50, ebn0=1.0
    ),
}

CONFIG_DIR = Path(__file__).resolve().parents[2] / "results" / "configs"
# The committed decoder configs in CONFIG_DIR -> the model whose code each was built for.
COMMITTED_CONFIGS = {
    "wlan_T16_0.8": "wlan-1296",
    "wlan_T32_0.6": "wlan-1296",
    "regular_T16_1.05": "regular-3-6-8000",
    "dvbs2_T16_0.6": "dvbs2-64800",
}


def rebuild_committed_config(name: str):
    """The port's construction of the committed config ``name`` from the
    settings saved in it (design Eb/N0, channel range, cardinalities, i_max)
    and its model's code (its degrees, or its check matrix when irregular)."""
    from ..construct import DecoderConfig, build_decoder_config
    from ..models import get_model

    ref = DecoderConfig.load(str(CONFIG_DIR / f"{name}.npz"))
    spec, t = get_model(COMMITTED_CONFIGS[name]), ref.tables
    kw = dict(design_ebn0_db=ref.design_ebn0_db, ad_max_abs=ref.ad_max_abs,
              cardinality_y_channel=ref.cardinality_y_channel,
              cardinality_t_channel=t.cardinality_t_channel,
              cardinality_t_decoder=t.cardinality_t_decoder, i_max=t.i_max)
    if spec.irregular:
        kw["H"] = spec.make_h()
    else:
        kw.update(d_v=spec.d_v, d_c=spec.d_c)
    return build_decoder_config(**kw)


def measure_sim_throughput(sim, ebn0_db: float, dispatches: int = 6) -> float:
    """Steady-state coded bits/s of a CUDA BERSimulator at one SNR point:
    the median over ``dispatches`` timed dispatches, each ended by
    ``torch.cuda.synchronize()``, after one warm-up dispatch."""
    if sim.device.type != "cuda":
        raise RuntimeError("throughput is measured on a CUDA device only")
    qt = sim.quantizer_for(ebn0_db)

    def run(i: int) -> None:
        sim._step(ebn0_db, i * sim.steps_per_dispatch, qt)
        torch.cuda.synchronize(sim.device)

    run(1000)  # warm-up: kernel build and first launch
    times = []
    for i in range(dispatches):
        t0 = time.perf_counter()
        run(i)
        times.append(time.perf_counter() - t0)
    bits = sim.layout.n_vars * sim.batch_total * sim.steps_per_dispatch
    return bits / statistics.median(times)


def measure_sim(sim, ebn0_db: float) -> tuple[float, float]:
    """(coded bits/s, mean iterations) of a CUDA BERSimulator at one point:
    the rate from :func:`measure_sim_throughput`, the mean iterations from
    two untimed dispatches (``scripts/bench_matrix.py:43-81``)."""
    bps = measure_sim_throughput(sim, ebn0_db)
    qt = sim.quantizer_for(ebn0_db)
    iters = [
        float(sim._step(ebn0_db, (7000 + i) * sim.steps_per_dispatch, qt)[2])
        for i in range(2)
    ]
    return bps, sum(iters) / len(iters)


# The decode kernels' names: K1, K2 and the passes of K3 and K4.
DECODE_KERNELS = ("ib_lut_fused_kernel", "float_fused_kernel", "seed_kernel", "cn_kernel",
                  "vn_kernel", "syndrome_kernel", "decide_kernel")


# The kernel that opens a step's channel input: the Philox kernel, for the
# encoded chain's info bits or for the whole input (csrc/philox_planes.cu).
DRAW_KERNEL = "channel_input_kernel"


def channel_input_ms(kernels: list[tuple[str, float, float]], steps: int) -> float | None:
    """Device milliseconds per step of the channel input in a profiled
    dispatch of ``steps`` steps, from its ``kernels`` as (name, start us,
    duration us): every kernel of a step from its first Philox launch to its
    decode launch (the encoded chain's info bits and encoder included). None
    when no decode kernel ran (``backend='xla'``)."""
    total, inside, decoded = 0.0, False, False
    for name, _, us in sorted(kernels, key=lambda k: k[1]):
        if any(k in name for k in DECODE_KERNELS):
            inside, decoded = False, True
            continue
        inside = inside or DRAW_KERNEL in name
        if inside:
            total += us
    return total / 1e3 / steps if decoded else None


def profile_dispatch(sim, ebn0_db: float, bps: float) -> dict:
    """Device milliseconds per kernel of one dispatch of a CUDA BERSimulator
    from ``torch.profiler`` (after an unprofiled one), and the shares of the
    dispatch's wall time that ``bps`` (:func:`measure_sim_throughput`)
    implies: the decode share is the decode kernels' time over it, the idle
    share one less all kernels' time over it; and the channel input's device
    milliseconds per step (:func:`channel_input_ms`)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    qt = sim.quantizer_for(ebn0_db)
    sim._step(ebn0_db, 9000 * sim.steps_per_dispatch, qt)
    torch.cuda.synchronize(sim.device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sim._step(ebn0_db, 9001 * sim.steps_per_dispatch, qt)
        torch.cuda.synchronize(sim.device)
    ms = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)
        if us:
            ms[e.key] = ms.get(e.key, 0.0) + us / 1e3
    if not ms:
        raise RuntimeError("the profiler saw no kernel on the card")
    wall = sim.layout.n_vars * sim.batch_total * sim.steps_per_dispatch / bps * 1e3
    decode = sum(v for k, v in ms.items() if any(n in k for n in DECODE_KERNELS))
    kernels = [(e.name, e.time_range.start, e.time_range.elapsed_us())
               for e in prof.events() if e.device_type == DeviceType.CUDA]
    return {
        "wall_ms": wall,
        "kernel_ms": dict(sorted(ms.items(), key=lambda kv: -kv[1])),
        "decode_share": decode / wall,
        "idle_share": 1 - sum(ms.values()) / wall,
        "channel_input_ms_per_step": channel_input_ms(kernels, sim.steps_per_dispatch),
    }


def build_matrix_sim(name: str, device: torch.device | str, codes: dict | None = None):
    """The BERSimulator of ``MATRIX[name]`` on ``device`` and its Eb/N0 and
    decoder tables (None for a float decoder). ``codes`` caches each
    model's (H, layout, host encoder) across cells."""
    from ..construct import DecoderConfig
    from ..decode import DeviceTrellis
    from ..encode import LDPCEncoder
    from ..models import get_model
    from ..sim import BERSimulator

    sc = MATRIX[name]
    spec = get_model(sc["model"])
    codes = {} if codes is None else codes
    chain = sc.get("chain", "allzero")
    if sc["model"] not in codes:
        H = spec.make_h()
        codes[sc["model"]] = [H, spec.make_layout(H), None]
    entry = codes[sc["model"]]
    if chain == "encoded" and entry[2] is None:
        entry[2] = LDPCEncoder(entry[0])
    kw = dict(
        chain=chain,
        count_all_bits=spec.count_all_bits and chain == "allzero",
        batch_per_device=sc.get("batch", 512),
        seed=0,
        steps_per_dispatch=sc.get("steps", 4),
        backend=sc.get("backend", "auto"),
        encoder=entry[2] if chain == "encoded" else None,
    )
    tables = None
    if sc["decoder"] == "ib":
        tables = DecoderConfig.load(str(CONFIG_DIR / f"{sc['config']}.npz")).tables
        kw.update(
            trellis=DeviceTrellis.from_tables(tables, device),
            cardinality_t_channel=tables.cardinality_t_channel,
        )
    else:
        kw["max_iters"] = sc.get("max_iters", spec.decode_i_max)
    sim = BERSimulator(entry[1], sc["decoder"], device=device, **kw)
    return sim, sc.get("ebn0", spec.design_ebn0_db), tables


def build_headline_sim(device: torch.device | str, **overrides):
    """The headline BERSimulator on ``device``; ``overrides`` replace its
    keyword arguments (``batch_per_device``, ``n_devices`` for a rank of a
    data-parallel group)."""
    from ..construct import DecoderConfig
    from ..decode import DeviceTrellis
    from ..models import get_model
    from ..sim import BERSimulator

    spec = get_model(HEADLINE["model"])
    cfg = DecoderConfig.load(str(CONFIG_DIR / f"{HEADLINE['config']}.npz"))
    kw = dict(
        trellis=DeviceTrellis.from_tables(cfg.tables, device),
        device=device,
        cardinality_t_channel=cfg.tables.cardinality_t_channel,
        chain=HEADLINE["chain"],
        count_all_bits=False,
        batch_per_device=HEADLINE["batch"],
        seed=0,
        steps_per_dispatch=HEADLINE["steps_per_dispatch"],
    )
    return BERSimulator(spec.make_layout(), HEADLINE["decoder"], **{**kw, **overrides})


def build_float_sim(name: str, device: torch.device | str):
    """The BERSimulator of ``FLOAT_SCENARIOS[name]`` on ``device``."""
    from ..models import get_model
    from ..sim import BERSimulator

    sc = FLOAT_SCENARIOS[name]
    return BERSimulator(
        get_model(sc["model"]).make_layout(),
        sc["decoder"],
        device=device,
        max_iters=sc["max_iters"],
        chain=sc["chain"],
        llr_source=sc["llr_source"],
        count_all_bits=sc["count_all_bits"],
        batch_per_device=sc["batch"],
        seed=sc["seed"],
        steps_per_dispatch=sc["steps_per_dispatch"],
    )


def build_dvbs2_sim(name: str, device: torch.device | str, layout=None, encoder=None,
                    **overrides):
    """The BERSimulator of ``DVBS2_SCENARIOS[name]`` on ``device``; a
    prebuilt DVB-S2 ``layout`` and host ``encoder`` save their few seconds of
    host work; ``overrides`` replace its keyword arguments."""
    from ..construct import DecoderConfig
    from ..decode import DeviceTrellis
    from ..encode import LDPCEncoder
    from ..models import get_model
    from ..sim import BERSimulator

    sc = DVBS2_SCENARIOS[name]
    spec = get_model(sc["model"])
    encoded = sc["chain"] == "encoded"
    if layout is None or (encoded and encoder is None):
        H = spec.make_h()
        layout = spec.make_layout(H) if layout is None else layout
        encoder = LDPCEncoder(H) if encoded and encoder is None else encoder
    kw = dict(max_iters=sc.get("max_iters"), llr_source=sc.get("llr_source", "quantized"))
    if sc["decoder"] == "ib":
        tables = DecoderConfig.load(str(CONFIG_DIR / f"{sc['config']}.npz")).tables
        kw.update(
            trellis=DeviceTrellis.from_tables(tables, device),
            cardinality_t_channel=tables.cardinality_t_channel,
        )
    kw.update(
        device=device,
        chain=sc["chain"],
        encoder=encoder if encoded else None,
        count_all_bits=False,
        batch_per_device=sc["batch"],
        seed=sc["seed"],
        steps_per_dispatch=sc["steps_per_dispatch"],
        backend=sc["backend"],
    )
    return BERSimulator(layout, sc["decoder"], **{**kw, **overrides})
