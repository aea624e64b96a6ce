"""One pipeline for the port's whole results tree.

Port of ``scripts/queue.py``: the same stages, work lists and flags, run
through the port's command lines. Stages (each idempotent and resumable:
rerunning skips finished work):

  configs  - build every decoder config that is missing (``cli/construct.py``,
             host numpy; its exit chart is skipped where matplotlib is missing)
  sweeps   - run every BER sweep in turn (``cli/simulate.py``); each sweep
             resumes from its results JSON
  extend   - reopen chosen completed points to collect more errors: the
             completed point becomes the engine's mid-point checkpoint again
             (:func:`reopen_point`), an exact continuation because a step's
             Philox key depends only on (seed, Eb/N0, step)
             (``sim/engine.py`` ``step_seed``)
  bench    - the benchmark matrix (``cli/bench_matrix.py``)
  report   - the parity report (``cli/parity_report.py``)

Every stage runs its command lines as child processes, so a crashing sweep
leaves the queue running. A stage runs all of its items and fails after
them if one failed; a failed stage stops no later one, and the run exits
non-zero naming the failed stages.

Everything is written under the output root (``--root``, default the
repository): configs to ``artifacts/torch/configs/``, logs to
``artifacts/torch/logs/``, results, ``.npz`` and ``.png`` to
``results/torch/ber/``, the matrix to ``results/torch/BENCH_MATRIX.json`` and
the report to ``results/torch/PARITY.md``. The JAX package's
``results/ber/``, ``artifacts/configs/`` and ``PARITY.md`` are never
written. ``--device`` (default ``cuda``) goes to every command line that
takes one (the sweeps and the matrix; construction and the report run on the
host).

Usage:
  python -m informationbottleneckdecodingldpc_torch.cli.queue            # everything
  python -m informationbottleneckdecodingldpc_torch.cli.queue --stages sweeps --only regular_ib_sib105
  python -m informationbottleneckdecodingldpc_torch.cli.queue --list
  python -m informationbottleneckdecodingldpc_torch.cli.queue --device cpu --root /tmp/q \\
      --stages configs --only wlan_T16_0.8
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shlex
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
PACKAGE = "informationbottleneckdecodingldpc_torch"
CFG_DIR = "artifacts/torch/configs"
LOG_DIR = "artifacts/torch/logs"
BER_DIR = "results/torch/ber"
STAGES = ("configs", "sweeps", "extend", "bench", "report")


# --------------------------------------------------------------------------
# Declarative work lists (scripts/queue.py's, entry for entry)

CONFIGS = [
    # (output name, construct-CLI args)
    ("wlan_T16_0.8", "--model wlan-1296 --ebn0 0.8"),
    ("wlan_T32_0.6", "--model wlan-1296-T32 --ebn0 0.6"),
    ("regular_T16_1.05", "--model regular-3-6-8000 --ebn0 1.05"),
    ("regular_T16_1.25", "--model regular-3-6-8000 --ebn0 1.25"),
    ("dvbs2_T16_0.6", "--model dvbs2-64800 --ebn0 0.6"),
    ("dvbs2_T16_0.8", "--model dvbs2-64800 --ebn0 0.8"),
    # The randomized-sIB construction (the reference's lin_sym_sIB with
    # nror=10) at the near-threshold design points.
    ("regular_T16_1.05_sib", "--model regular-3-6-8000 --ebn0 1.05 --ib-backend sib --nror 10"),
    ("dvbs2_T16_0.6_sib", "--model dvbs2-64800 --ebn0 0.6 --ib-backend sib --nror 10"),
]


@dataclasses.dataclass
class Sweep:
    name: str
    args: str  # simulate-CLI args (device, results and export paths added)

    @property
    def results(self) -> str:
        return f"{BER_DIR}/{self.name}.json"

    def argv(self, device: str, extra: tuple[str, ...] = ()) -> list[str]:
        return [
            sys.executable, "-m", f"{PACKAGE}.cli.simulate", *shlex.split(self.args), *extra,
            "--device", device, "--results", self.results,
            "--export-npz", f"{BER_DIR}/{self.name}.npz",
            "--export-plot", f"{BER_DIR}/{self.name}.png",
        ]


SWEEPS = [
    # Reference operating points: BASELINE.md:20-29 / SURVEY.md §6.
    Sweep("wlan_ib_T16_enc",
          f"--model wlan-1296 --decoder ib --config {CFG_DIR}/wlan_T16_0.8.npz "
          "--chain encoded --start-db 0.6 --min-errors 7000 "
          "--batch-per-device 512 --steps-per-dispatch 8 --seed 20"),
    Sweep("wlan_minsum_enc",
          "--model wlan-1296 --decoder minsum --chain encoded --start-db 0.6 "
          "--min-errors 7000 --batch-per-device 512 --steps-per-dispatch 8 --seed 21"),
    Sweep("wlan_bp_enc",
          "--model wlan-1296 --decoder bp --chain encoded --start-db 0.6 "
          "--min-errors 7000 --batch-per-device 512 --steps-per-dispatch 8 --seed 22"),
    Sweep("regular_ib_allzero",
          f"--model regular-3-6-8000 --decoder ib --config {CFG_DIR}/regular_T16_1.05.npz "
          "--chain allzero --start-db 0.5 --min-errors 7000 "
          "--batch-per-device 256 --steps-per-dispatch 4 --seed 23"),
    Sweep("regular_ib_d125",
          f"--model regular-3-6-8000 --decoder ib --config {CFG_DIR}/regular_T16_1.25.npz "
          "--chain allzero --start-db 0.8 --min-errors 7000 "
          "--batch-per-device 256 --steps-per-dispatch 4 --seed 29"),
    Sweep("regular_ib_sib105",
          f"--model regular-3-6-8000 --decoder ib --config {CFG_DIR}/regular_T16_1.05_sib.npz "
          "--chain allzero --start-db 0.5 --min-errors 7000 "
          "--batch-per-device 256 --steps-per-dispatch 4 --seed 31"),
    Sweep("wlan_ib_T32_enc",
          f"--model wlan-1296-T32 --decoder ib --config {CFG_DIR}/wlan_T32_0.6.npz "
          "--chain encoded --start-db 0.6 --min-errors 7000 "
          "--batch-per-device 512 --steps-per-dispatch 8 --seed 24"),
    Sweep("regular_minsum",
          "--model regular-3-6-8000 --decoder minsum --chain allzero --start-db 0.5 "
          "--max-iters 50 --min-errors 7000 --batch-per-device 256 "
          "--steps-per-dispatch 4 --seed 26"),
    Sweep("dvbs2_ib_enc",
          f"--model dvbs2-64800 --decoder ib --config {CFG_DIR}/dvbs2_T16_0.6.npz "
          "--chain encoded --start-db 0.6 --max-db 1.3 --min-errors 5000 "
          "--target-ber 1e-5 --max-blocks-per-point 200000 "
          "--batch-per-device 128 --seed 25"),
    Sweep("dvbs2_ib_enc_d08",
          f"--model dvbs2-64800 --decoder ib --config {CFG_DIR}/dvbs2_T16_0.8.npz "
          "--chain encoded --start-db 0.8 --max-db 1.3 --min-errors 5000 "
          "--target-ber 1e-7 --max-blocks-per-point 200000 "
          "--batch-per-device 128 --seed 28"),
    Sweep("dvbs2_minsum",
          "--model dvbs2-64800 --decoder minsum --chain allzero --start-db 0.6 "
          "--max-db 1.3 --min-errors 5000 --target-ber 1e-5 "
          "--max-blocks-per-point 200000 --batch-per-device 128 --seed 27"),
    # The reference's argv |T|=32 min-sum mode
    # (DVB-S2/BER_simulation_OpenCL_min_sum.py:49-50).
    Sweep("dvbs2_minsum_T32",
          "--model dvbs2-64800 --decoder minsum --t-channel 32 "
          "--chain allzero --start-db 0.6 "
          "--max-db 1.3 --min-errors 5000 --target-ber 1e-5 "
          "--max-blocks-per-point 200000 --batch-per-device 128 --seed 34"),
    # 16-QAM through the exact soft demapper into min-sum, on the Eb/N0 axis
    # of the BPSK min-sum curve.
    Sweep("wlan_minsum_qam16",
          "--model wlan-1296 --decoder minsum --chain encoded "
          "--modulation qam16 --start-db 1.0 --max-db 4.5 --min-errors 7000 "
          "--batch-per-device 512 --steps-per-dispatch 8 --seed 33"),
    # 8-PSK (the reference's LDPC_MPSK_Transmitter,
    # AWGN_Channel_Transmission/LDPC_Transmitter.py:177) into min-sum.
    Sweep("wlan_minsum_psk8",
          "--model wlan-1296 --decoder minsum --chain encoded "
          "--modulation psk8 --start-db 1.5 --max-db 5.0 --min-errors 7000 "
          "--batch-per-device 512 --steps-per-dispatch 8 --seed 34"),
]


@dataclasses.dataclass
class Extension:
    """Reopen sweep's completed point at ``ebn0_db`` until ``min_errors`` or
    ``max_blocks`` (whichever first). ``batch`` must match the sweep's
    batch_per_device * n_devices (step index = blocks / batch)."""

    sweep: str
    ebn0_db: float
    min_errors: int
    max_blocks: int
    batch: int


EXTENSIONS = [
    # Thin tails: collect the reference's 1000-7000 errors at these points.
    Extension("dvbs2_ib_enc_d08", 1.1, 1000, 1_500_000, 128),
    Extension("wlan_ib_T16_enc", 2.4, 7000, 30_000_000, 512),
    Extension("wlan_ib_T32_enc", 2.3, 7000, 30_000_000, 512),
]


# --------------------------------------------------------------------------


def reopen_point(results_path: str, ebn0_db: float, batch: int) -> bool:
    """Turn the completed point at ``ebn0_db`` back into the mid-point
    checkpoint (``partial``) of its results file, as ``scripts/queue.py``
    does; False when the file holds no such point. Raises ``SystemExit``
    when later points exist, and ``ValueError`` when ``batch`` does not
    divide the point's blocks."""
    with open(results_path) as f:
        payload = json.load(f)
    pts = payload["points"]
    idx = next((i for i, p in enumerate(pts) if abs(p["ebn0_db"] - ebn0_db) < 1e-9), None)
    if idx is None:
        return False
    p = pts.pop(idx)
    if any(q["ebn0_db"] > ebn0_db for q in pts):
        raise SystemExit(f"{results_path}: cannot reopen {ebn0_db} dB — later points exist")
    if p["blocks"] % batch:
        raise ValueError(f"batch {batch} must match the original sweep's (blocks {p['blocks']})")
    payload["partial"] = dict(
        ebn0_db=p["ebn0_db"],
        step_index=p["blocks"] // batch,
        errors=p["errors"],
        frame_errors=p["frame_errors"],
        blocks=p["blocks"],
        iters_sum=p["mean_iterations"] * p["blocks"],
    )
    tmp = results_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=2)
    os.replace(tmp, results_path)
    return True


class Queue:
    """The stages over one output root: child processes start there, with
    this checkout's package on their path."""

    def __init__(self, root: str | os.PathLike, device: str):
        self.root = Path(root).resolve()
        self.device = device
        self.env = dict(os.environ)
        self.env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(REPO), os.environ.get("PYTHONPATH")]))
        for d in (CFG_DIR, LOG_DIR, BER_DIR):
            (self.root / d).mkdir(parents=True, exist_ok=True)

    def sh(self, argv: list[str], log: str | None = None) -> int:
        """Run ``argv`` in the root, its output appended to ``log`` when given."""
        line = shlex.join(argv)
        print(f"[{time.strftime('%H:%M:%S')}] $ {line}" + (f" > {log}" if log else ""), flush=True)
        if log is None:
            return subprocess.call(argv, cwd=self.root, env=self.env)
        with open(self.root / log, "a") as f:
            return subprocess.call(argv, cwd=self.root, env=self.env, stdout=f, stderr=f)

    @staticmethod
    def check(stage: str, failed: list[str]) -> None:
        if failed:
            raise RuntimeError(f"{stage}: {', '.join(failed)} failed")

    def configs(self, configs, only) -> None:
        failed = []
        for name, args in configs:
            if only and name not in only:
                continue
            out = f"{CFG_DIR}/{name}.npz"
            if (self.root / out).exists():
                print(f"config {name}: exists", flush=True)
                continue
            rc = self.sh(
                [sys.executable, "-m", f"{PACKAGE}.cli.construct", *shlex.split(args),
                 "--output", out, "--export-exit-chart", f"{CFG_DIR}/{name}_exit.png",
                 "--verbose"],
                log=f"{LOG_DIR}/config_{name}.log",
            )
            print(f"config {name}: {'done' if rc == 0 else 'FAILED'}", flush=True)
            if rc:
                failed.append(name)
        self.check("configs", failed)

    def sweeps(self, sweeps, only) -> None:
        failed = []
        for s in sweeps:
            if only and s.name not in only:
                continue
            rc = self.sh(s.argv(self.device), log=f"{LOG_DIR}/sweep_{s.name}.log")
            print(f"sweep {s.name}: {'done' if rc == 0 else 'FAILED'}", flush=True)
            if rc:
                failed.append(s.name)
        self.check("sweeps", failed)

    def extend(self, sweeps, extensions, only) -> None:
        by_name = {s.name: s for s in sweeps}
        failed = []
        for e in extensions:
            if only and e.sweep not in only:
                continue
            s = by_name[e.sweep]
            results = str(self.root / s.results)
            with open(results) as f:
                pts = json.load(f)["points"]
            cur = next((p for p in pts if abs(p["ebn0_db"] - e.ebn0_db) < 1e-9), None)
            if cur is None:
                print(f"extend {e.sweep}@{e.ebn0_db}: point is already open/absent", flush=True)
            elif cur["errors"] >= e.min_errors or cur["blocks"] >= e.max_blocks:
                print(f"extend {e.sweep}@{e.ebn0_db}: already at {cur['errors']} errors / "
                      f"{cur['blocks']} blocks", flush=True)
                continue
            else:
                reopen_point(results, e.ebn0_db, e.batch)
            rc = self.sh(
                s.argv(self.device, ("--min-errors", str(e.min_errors),
                                     "--max-blocks-per-point", str(e.max_blocks))),
                log=f"{LOG_DIR}/extend_{e.sweep}.log",
            )
            print(f"extend {e.sweep}@{e.ebn0_db}: {'done' if rc == 0 else 'FAILED'}", flush=True)
            if rc:
                failed.append(f"{e.sweep}@{e.ebn0_db}")
        self.check("extend", failed)

    def bench(self) -> None:
        rc = self.sh([sys.executable, "-m", f"{PACKAGE}.cli.bench_matrix", "--device", self.device,
                      "--out", "results/torch/BENCH_MATRIX.json"],
                     log=f"{LOG_DIR}/bench_matrix.log")
        self.check("bench", ["bench_matrix"] if rc else [])

    def report(self) -> None:
        rc = self.sh([sys.executable, "-m", f"{PACKAGE}.cli.parity_report",
                      "--results-dir", BER_DIR, "--out", "results/torch/PARITY.md"])
        self.check("report", ["parity_report"] if rc else [])


def run(stages, configs, sweeps, extensions, root=REPO, device: str = "cuda",
        only=None) -> list[str]:
    """Run ``stages`` (in the order of :data:`STAGES`) over the given work
    lists under ``root``; ``only`` restricts them to the named configs and
    sweeps. Returns the names of the stages that failed (each stage runs,
    whatever failed before it)."""
    unknown = set(stages) - set(STAGES)
    if unknown:
        raise ValueError(f"unknown stages {sorted(unknown)}; expected some of {STAGES}")
    q = Queue(root, device)
    work = {
        "configs": lambda: q.configs(configs, only),
        "sweeps": lambda: q.sweeps(sweeps, only),
        "extend": lambda: q.extend(sweeps, extensions, only),
        "bench": q.bench,
        "report": q.report,
    }
    failures = []
    for name in STAGES:
        if name not in stages:
            continue
        try:
            work[name]()
        except (Exception, SystemExit) as e:  # noqa: BLE001 - keep the queue running
            print(f"stage {name} FAILED: {e!r}", flush=True)
            failures.append(name)
    return failures


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--stages", default=",".join(STAGES))
    ap.add_argument("--only", default=None,
                    help="comma-separated config/sweep names to restrict to")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="the sweeps' and the matrix's device (default: cuda)")
    ap.add_argument("--root", default=str(REPO),
                    help="output root (default: the repository)")
    args = ap.parse_args(argv)
    if args.list:
        print("configs:", *(n for n, _ in CONFIGS), sep="\n  ")
        print("sweeps:", *(s.name for s in SWEEPS), sep="\n  ")
        print("extensions:",
              *(f"{e.sweep}@{e.ebn0_db} -> {e.min_errors} errors" for e in EXTENSIONS),
              sep="\n  ")
        return
    only = set(args.only.split(",")) if args.only else None
    failures = run(args.stages.split(","), CONFIGS, SWEEPS, EXTENSIONS, args.root, args.device,
                   only)
    if failures:
        raise SystemExit(f"failed stages: {','.join(failures)}")


if __name__ == "__main__":
    main()
