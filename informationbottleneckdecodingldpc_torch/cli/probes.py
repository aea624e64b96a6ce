"""Run the probes P1-P6 on one CUDA card and write their rates.

Port of the main functions of ``scripts/mxu_col_probe.py`` (P1: LUT column
builds on CUDA cores and on tensor cores), ``scripts/read_bw_probe.py`` and
``scripts/read_bw_probe2.py`` (P2, P3: device-memory reads staged by bulk
copies, by chunk size and stream layout), ``scripts/dma_probe.py`` (P4:
the cost of a bulk copy and of a wait, scatter and stage),
``scripts/stage_probe.py`` (P5: the staged 7-plane skeleton of a decode
iteration) and ``scripts/stage_replay.py`` (P6: the port's K3 pass program
with the folds replaced, beside K3's own time per body). Each variant
prints one line in the JAX scripts' form with its rate beside its data-sheet
bound (``utils/probes.py``). The output, ``results/torch/PROBES.json`` by
default, records the card's name, count and power limit. There is no CPU
measurement: without a CUDA device the run raises.

Usage:
  python -m informationbottleneckdecodingldpc_torch.cli.probes \\
      [--only p1,p2,p3,p4,p5,p6] [--out results/torch/PROBES.json]
"""

from __future__ import annotations

import argparse
import json
import os
from pathlib import Path

import torch

from ..utils import probes
from .bench_matrix import card

DEFAULT_OUT = Path(__file__).resolve().parents[2] / "results" / "torch" / "PROBES.json"
PROBES = ("p1", "p2", "p3", "p4", "p5", "p6")


def run(names: list[str], device: torch.device) -> dict:
    """Measure the probes ``names`` on ``device``."""
    out = {"device": card()}
    if "p1" in names:
        out["p1"] = probes.measure_columns(device)
    reads = [n for n in ("p2", "p3") if n in names]
    if reads:
        out["reads"] = probes.measure_reads(reads, device)
    if "p4" in names:
        out["p4"] = probes.measure_copies(device)
    if "p5" in names:
        out["p5"] = probes.measure_stage(device)
    if "p6" in names:
        out["p6"] = probes.measure_replay(device)
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    p.add_argument("--only", default="", help="comma-separated probes of " + ",".join(PROBES))
    p.add_argument("--out", default=str(DEFAULT_OUT))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the probes run on a CUDA device only; none is available")
    names = [n for n in args.only.split(",") if n] or list(PROBES)
    unknown = sorted(set(names) - set(PROBES))
    if unknown:
        raise KeyError(f"unknown probes {unknown}; available: {list(PROBES)}")
    out = run(names, torch.device("cuda"))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
