"""Decide ``correct``: the sampled dispatches of the window against the plain
reference (``reference/chain.py``), layer by layer.

Every number compared is a count of disagreements with the limit 0 (an
exact comparison):

- ``input_mismatch``: elements of the decoder's input (channel input layer);
- ``codeword_mismatch``: transmitted bits (the encoder, encoded chain only);
- ``decision_mismatch``: hard decisions of the decoder's outputs (decode);
- ``count_mismatch``: the sum over dispatches of the gaps in bit errors and
  in frame errors between what reached the host and the reference (counting);
- ``iteration_mismatch``: steps and dispatches whose mean bodies differ
  from the reference's, as float32 (decode and counting).

``dispatches_compared`` has to be at least 1.
"""

from __future__ import annotations

import numpy as np
import torch

LIMITS = {"input_mismatch": 0, "codeword_mismatch": 0, "decision_mismatch": 0,
          "count_mismatch": 0, "iteration_mismatch": 0}


def _deltas(marks: list, d: int) -> tuple[int, int]:
    before = (marks[d - 1].errors, marks[d - 1].frame_errors) if d else (0, 0)
    return marks[d].errors - before[0], marks[d].frame_errors - before[1]


def judge(reference, records: dict, marks: list, *, seed: int, ebn0_db: float, first_step: int,
          steps_per_dispatch: int, batch: int, chain: str, tile: int) -> tuple[dict, int]:
    """The checks (name -> value, limit, rule) and the number of compared
    dispatches that disagree anywhere."""
    compared = sorted(d for d, r in records.items()
                      if "counters" in r and d < len(marks) and len(r["outputs"]) == steps_per_dispatch)
    totals = dict.fromkeys(LIMITS, 0)
    failed = 0
    for d in compared:
        rec = records[d]
        steps = [first_step + d * steps_per_dispatch + j for j in range(steps_per_dispatch)]
        ref = reference.steps(seed, ebn0_db, steps, batch, chain, tile)
        bad = dict.fromkeys(LIMITS, 0)
        acc = None
        for j, r in enumerate(ref):
            device = r["input"].device
            bad["input_mismatch"] += int((rec["inputs"][j].to(device) != r["input"]).sum())
            if r["codeword"] is not None:
                cw = rec["codewords"][j].to(device) if j < len(rec["codewords"]) else None
                bad["codeword_mismatch"] += (r["codeword"].numel() if cw is None
                                             else int((cw != r["codeword"]).sum()))
            hard = reference.decoder.hard(rec["outputs"][j].to(device))
            bad["decision_mismatch"] += int((hard != r["hard"]).sum())
            bad["iteration_mismatch"] += int(np.float32(float(rec["bodies"][j])) != r["mean_bodies"])
            acc = r["mean_bodies"] if acc is None else np.float32(acc + r["mean_bodies"])
        errors = sum(int(r["errors"].sum()) for r in ref)
        frames = sum(int((r["errors"] > 0).sum()) for r in ref)
        got_e, got_f = _deltas(marks, d)
        bad["count_mismatch"] = abs(got_e - errors) + abs(got_f - frames)
        mean = np.float32(acc / np.float32(steps_per_dispatch))
        bad["iteration_mismatch"] += int(np.float32(float(rec["counters"][2])) != mean)
        failed += any(bad.values())
        for k, v in bad.items():
            totals[k] += v
        del ref
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    if chain != "encoded":
        del totals["codeword_mismatch"]
    checks = {k: {"value": v, "limit": LIMITS[k], "rule": "<="} for k, v in totals.items()}
    checks["dispatches_compared"] = {"value": len(compared), "limit": 1, "rule": ">="}
    return checks, failed


def holds(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] if c["rule"] == "<=" else c["value"] >= c["limit"]
               for c in checks.values())
