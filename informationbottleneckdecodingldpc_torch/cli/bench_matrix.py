"""Run the benchmark matrix on one CUDA card and write its roofline.

Port of ``scripts/bench_matrix.py``: every cell of ``utils.benchmarks.MATRIX``
(or those named by ``--only``) is timed with ``measure_sim`` (the median of 6
dispatches after a warm-up, the mean iterations from two more), then the
primitive peaks (K5, ``utils/peaks.py``) and the copy bandwidth (K6 and
``copy_``, ``utils/roofline.py``) are measured and every cell gets its bound and
``fraction_of_sol`` (``utils/roofline.py`` ``cell_roofline``). The output has
the JAX script's layout (``scenarios`` and ``roofline``) and records the card
(name, count, power limit) in every result. The default output is
``results/torch/BENCH_MATRIX.json``; the JAX package's
``results/BENCH_MATRIX.json`` (TPU numbers) is never written. There is no CPU
measurement: without a CUDA device the run raises.

Usage:
  python -m informationbottleneckdecodingldpc_torch.cli.bench_matrix \\
      [--out results/torch/BENCH_MATRIX.json] [--only wlan_ib_fused,dvbs2_minsum]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
from pathlib import Path

import torch

from ..kernels.peaks import FLOAT_OPS, LOOKUPS
from ..utils.benchmarks import MATRIX, build_matrix_sim, measure_sim
from ..utils.peaks import _CACHE, primitive_peak
from ..utils.roofline import cell_roofline, traffic_bandwidth

DEFAULT_OUT = Path(__file__).resolve().parents[2] / "results" / "torch" / "BENCH_MATRIX.json"
LOOKUP_T = (16, 32)  # the decoders' message cardinalities

NOTE = (
    "IB bounds: the pairwise and 1-D lookups K1/K3 make per iteration "
    "against their peaks measured with register-resident CUDA chains (K5a, "
    "K5b; a pairwise lookup at the faster of K5b's two table layouts, shared "
    "by a block or copied per lane); float bounds: box-plus applications (BP) or 4 ops per check edge "
    "against 7 x the min-sum op rate (K5c); cells on backend 'hbm' also get "
    "the device-memory traffic bound of their views against the measured "
    "copy bandwidth (the faster of K6 and torch's copy_), and keep the "
    "smaller rate. i_eff is the measured "
    "mean iteration count of the same cell."
)


def card() -> dict:
    """Name, count and power limit of the CUDA cards."""
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        limit = "not measured"
    return {
        "name": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "power_limit": limit,
    }


def run(names: list[str], device: torch.device) -> dict:
    """Time the cells ``names`` on ``device`` and compute their roofline."""
    dev_record = card()
    out = {"unit": "coded_bits_per_s", "device": dev_record, "scenarios": {}}
    info, codes = {}, {}
    for name in names:
        sim, ebn0, tables = build_matrix_sim(name, device, codes)
        decoder = sim.fused_decoder
        bps, mean_iters = measure_sim(sim, ebn0)
        kernel = sim.backend != "xla"
        out["scenarios"][name] = {
            "coded_mbps": bps / 1e6,
            "model": MATRIX[name]["model"],
            "decoder": sim.decoder,
            "chain": sim.chain,
            "backend": sim.backend,
            "batch": sim.batch_per_device,
            "steps_per_dispatch": sim.steps_per_dispatch,
            "ebn0_db": ebn0,
            "mean_iterations": mean_iters,
            "decoder_class": type(decoder).__name__,
            "kernel_launches" if kernel else "whole_batch_calls": (
                decoder.launches if kernel else decoder.calls
            ),
            "device": dev_record,
        }
        matching = sim.trellis is not None and sim.trellis.matching_cn is not None
        info[name] = (sim.layout, tables, matching)
        print(f"{name}: {bps / 1e6:.2f} Mbit/s coded ({mean_iters:.2f} iterations, "
              f"{sim.backend}, {type(decoder).__name__})", flush=True)
        del sim, decoder
        torch.cuda.empty_cache()

    for t in LOOKUP_T:
        for kind in LOOKUPS:
            primitive_peak(kind, t)
    for op in FLOAT_OPS:
        primitive_peak(op)
    bandwidth = traffic_bandwidth(device)
    bw = bandwidth["bytes_per_s"]
    roof = {
        "measured_hbm_bandwidth_GBps": bw / 1e9,
        "k6_copy_GBps": bandwidth["k6"] / 1e9,
        "torch_copy_GBps": bandwidth["copy_"] / 1e9,
        "primitive_peaks_G_per_s": {
            "_".join(map(str, k)): v / 1e9 for k, v in _CACHE.items()
        },
        "note": NOTE,
        "device": dev_record,
    }
    for name, (layout, tables, matching) in info.items():
        sc = out["scenarios"][name]
        entry = cell_roofline(
            layout, sc["decoder"], sc["backend"], sc["mean_iterations"],
            primitive_peak, bw, tables=tables, use_matching=matching,
            achieved_bps=sc["coded_mbps"] * 1e6,
        )
        roof[name] = entry
        print(f"roofline {name}: {entry['bound']}, SOL "
              f"{entry['speed_of_light_coded_mbps']:.1f} Mbit/s, achieved "
              f"{entry['achieved_coded_mbps']:.1f} ({entry['fraction_of_sol']:.2%})",
              flush=True)
    out["roofline"] = roof
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    p.add_argument("--out", default=str(DEFAULT_OUT))
    p.add_argument("--only", default="", help="comma-separated cell names")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("the benchmark matrix runs on a CUDA device only")
    names = [n for n in args.only.split(",") if n] or list(MATRIX)
    unknown = sorted(set(names) - set(MATRIX))
    if unknown:
        raise KeyError(f"unknown cells {unknown}; available: {list(MATRIX)}")
    out = run(names, device)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
