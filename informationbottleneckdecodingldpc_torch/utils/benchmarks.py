"""The headline throughput scenario, the benchmark matrix, and their timing.

Port of ``utils/benchmarks.py``: WLAN 802.11n N=1296 R=1/2, the irregular IB
decoder with message alignment (|T|=16, i_max=50, checked-in config
``results/configs/wlan_T16_0.8.npz``), the fused kernel, all-zeros chain at
0.8 dB, batch 4096 x 8 Monte-Carlo steps per dispatch. Metric: decoded coded
bits/s per device, the median of timed dispatches after one warm-up.
``HEADLINE`` is the matrix's ``wlan_ib_fused`` cell, which
:func:`build_headline_sim` builds.

``MATRIX`` are the 12 cells of ``scripts/bench_matrix.py:318-350`` with
their names, models, decoders, chains, backends, SNRs and batches, built by
:func:`build_matrix_sim` and run by ``cli/bench_matrix.py``: unset keys take
the JAX script's defaults (chain ``allzero``, backend ``auto``, batch 512 x 4
steps, the model's design Eb/N0 and decode i_max); the float decoders read
16-level quantized LLRs. The DVB-S2 cells run at batch 1024 x 1 step (the JAX
matrix used 128 for the TPU's VMEM; a card holds 1024: K4's float views are
1.86 GB); the all-zeros cells of the regular code count every bit, the
others the info bits.
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


def build_matrix_sim(name: str, device: torch.device | str, codes: dict | None = None,
                     **overrides):
    """The BERSimulator of ``MATRIX[name]`` on ``device`` and its Eb/N0 and
    decoder tables (None for a float decoder). ``codes`` caches each
    model's (H, layout, host encoder) across cells, or hands in prebuilt
    ones; ``overrides`` replace the simulator's keyword arguments
    (``batch_per_device``, ``n_devices`` for a rank of a data-parallel
    group)."""
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
    sim = BERSimulator(entry[1], sc["decoder"], device=device, **{**kw, **overrides})
    return sim, sc.get("ebn0", spec.design_ebn0_db), tables


def build_headline_sim(device: torch.device | str, **overrides):
    """The headline BERSimulator on ``device``: the matrix's
    ``wlan_ib_fused`` cell, ``overrides`` replacing its keyword arguments."""
    return build_matrix_sim("wlan_ib_fused", device, **overrides)[0]
