"""Eb/N0 sweep with per-point persistence and resume.

Port of ``sim/sweep.py``: sweep Eb/N0 from a start value in fixed steps
(finer once the BER drops below a threshold) until the BER reaches the
target or Eb/N0 its cap, saving the results after every point. Completed
points are reloaded from the results file and the sweep goes on after the
last one; the point in progress is saved every ``checkpoint_every_steps``
steps and resumed from its counters.
"""

from __future__ import annotations

import dataclasses
import os

from .engine import BERSimulator, PointCheckpoint, PointResult
from .results import load_partial, load_results, save_results


@dataclasses.dataclass
class SweepSchedule:
    start_db: float = 0.0
    normal_step_db: float = 0.1
    small_step_db: float = 0.1
    small_step_below_ber: float = 1e-6
    max_db: float = 2.0
    target_ber: float = 1e-6
    min_errors: int = 7000
    max_blocks_per_point: int = 10_000_000
    checkpoint_every_steps: int = 50  # persist mid-point counters this often


@dataclasses.dataclass
class SweepController:
    """Runs a :class:`SweepSchedule` on a simulator. ``resume_state`` (the
    results file's payload, passed in by the caller) takes the place of the
    file when given; with ``write_results`` False nothing is written."""

    simulator: BERSimulator
    schedule: SweepSchedule
    results_path: str | None = None
    verbose: bool = True
    write_results: bool = True
    resume_state: dict | None = None

    def run(self) -> list[PointResult]:
        sched = self.schedule
        results: list[PointResult] = []
        partial: dict | None = None
        if self.resume_state is not None:
            results = [PointResult(**p) for p in self.resume_state.get("points", [])]
            partial = self.resume_state.get("partial")
            if self.verbose and results:
                print(f"resuming sweep from the given state: {len(results)} completed points "
                      f"up to {results[-1].ebn0_db:.2f} dB")
        elif self.results_path and os.path.exists(self.results_path):
            results = load_results(self.results_path)
            partial = load_partial(self.results_path)
            if self.verbose and results:
                print(f"resuming sweep: {len(results)} completed points up to "
                      f"{results[-1].ebn0_db:.2f} dB")
            if self.verbose and partial:
                print(f"resuming mid-point at {partial['ebn0_db']:.2f} dB: "
                      f"{partial['errors']} errors / {partial['blocks']} blocks")

        while True:
            if results:
                last = results[-1]
                if last.ber <= sched.target_ber or last.ebn0_db >= sched.max_db:
                    break
                step = (sched.small_step_db if last.ber < sched.small_step_below_ber
                        else sched.normal_step_db)
                ebn0 = round(last.ebn0_db + step, 6)
            else:
                ebn0 = sched.start_db

            checkpoint = None
            if partial is not None and abs(partial["ebn0_db"] - ebn0) < 1e-9:
                checkpoint = PointCheckpoint(**partial)
            partial = None

            def persist_partial(state: PointCheckpoint):
                if (self.write_results and self.results_path
                        and state.step_index % sched.checkpoint_every_steps == 0):
                    save_results(self.results_path, results, partial=dataclasses.asdict(state))

            point = self.simulator.run_point(
                ebn0,
                min_errors=sched.min_errors,
                max_blocks=sched.max_blocks_per_point,
                verbose=self.verbose,
                checkpoint=checkpoint,
                on_progress=persist_partial,
            )
            results.append(point)
            if self.verbose:
                print(f"EbN0={point.ebn0_db:.2f} dB BER={point.ber:.3e} FER={point.fer:.3e} "
                      f"blocks={point.blocks} coded_bps={point.coded_bits_per_s:.3e}", flush=True)
            if self.write_results and self.results_path:
                save_results(self.results_path, results)
        return results
