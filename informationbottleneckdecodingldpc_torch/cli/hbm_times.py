"""Time one DVB-S2 decode of each device-memory decoder on one CUDA card.

The inputs and settings of ``chip_smoke.py`` phase 15: DVB-S2 R=1/2
N=64800 at batch 1024 and 1.0 dB (channel draws from ``torch.Generator``
seed 99), i_max 50, default tiles; K3 (IB |T|=16 designed at 0.6 dB, early
exit off), K4 min-sum with early exit off and on (no tile leaves at 1.0 dB,
so both run 49 bodies) and K4 BP with early exit off. Each time is the mean
of ``--reps`` decodes after a warm-up, by CUDA events.

The decoders are imported from the checkout ``--tree`` (default: the one
this file is in), put first on ``sys.path``, and only entry points that the
package has had since its DVB-S2 path are used, so two checkouts can be
timed one after the other in one session on one card:

  python3 informationbottleneckdecodingldpc_torch/cli/hbm_times.py \\
      [--tree build/parent] [--out chiprun_out/hbm_times.json] [--reps 5]

Prints and writes one JSON object: ms per decoder, the mean iterations and
the card's name and power limit. Without a CUDA device it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

TREE = Path(__file__).resolve().parents[2]
BATCH = 1024
EBN0_DB = 1.0
CONFIG = "dvbs2_T16_0.6"
SEED = 99


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` calls after a warm-up."""
    fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def run(reps: int) -> dict:
    """The times, with the package of the checkout first on ``sys.path``."""
    from informationbottleneckdecodingldpc_torch.channel import (
        build_quantizer_tables,
        device_tables,
        sample_clusters_from_uniform,
        sample_llrs_from_uniform,
        sigma2_from_ebn0_db,
    )
    from informationbottleneckdecodingldpc_torch.construct import DecoderConfig
    from informationbottleneckdecodingldpc_torch.kernels import HBMFloatDecoder, HBMFusedIBDecoder
    from informationbottleneckdecodingldpc_torch.models import get_model
    from informationbottleneckdecodingldpc_torch.utils.benchmarks import CONFIG_DIR

    dev = torch.device("cuda")
    layout = get_model("dvbs2-64800").make_layout()
    tables = DecoderConfig.load(str(CONFIG_DIR / f"{CONFIG}.npz")).tables
    sigma2 = float(sigma2_from_ebn0_db(EBN0_DB, layout.code_rate))
    shape = (layout.n_vars, BATCH)
    zeros = torch.zeros(shape, dtype=torch.int32, device=dev)

    def uniforms() -> torch.Tensor:
        g = torch.Generator(device=dev)
        g.manual_seed(SEED)
        return torch.rand(shape, generator=g, device=dev)

    qt_ib = device_tables(
        build_quantizer_tables(sigma2, 3.0, tables.cardinality_t_channel, 2000), dev
    )
    clusters = sample_clusters_from_uniform(qt_ib.cdf, uniforms(), zeros)
    qt = device_tables(build_quantizer_tables(sigma2, 3.0, 16, 2000), dev)
    llrs = sample_llrs_from_uniform(qt.cdf, qt.llrs, uniforms(), zeros)
    decoders = {
        "k3": (HBMFusedIBDecoder(layout, tables, early_exit=False), clusters),
        "k4_minsum": (HBMFloatDecoder(layout, "minsum", max_iters=50, early_exit=False), llrs),
        "k4_minsum_early_exit": (HBMFloatDecoder(layout, "minsum", max_iters=50), llrs),
        "k4_bp": (HBMFloatDecoder(layout, "bp", max_iters=50, early_exit=False), llrs),
    }
    ms, iterations = {}, {}
    for name, (dec, x) in decoders.items():
        ms[name] = cuda_ms(lambda: dec(x), reps)
        iterations[name] = float(dec(x).iterations)
        print(f"{name}: {ms[name]:.3f} ms, mean iterations {iterations[name]:.3f}", flush=True)
    return {"batch": BATCH, "ebn0_db": EBN0_DB, "reps": reps, "ms": ms,
            "mean_iterations": iterations}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    p.add_argument("--tree", default=str(TREE))
    p.add_argument("--out", default="")
    p.add_argument("--reps", type=int, default=5)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("hbm_times runs on a CUDA device only")
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    out = {"tree": str(tree), **run(args.reps), "card": nvidia_smi()}
    print(json.dumps(out), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
