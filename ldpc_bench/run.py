"""Run one cell of the benchmark once, on one CUDA card, and print its result.

    python3 -m ldpc_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up: the configuration's code and tables are loaded, the port's engine is
built (``harness/program.py``) and runs two dispatches outside the window,
the second timed. ``setup_s`` runs from the process's start to the window's.

The window: dispatches through ``BERSimulator.run_point`` from step 0,
resumed in chunks until ``--seconds`` have passed (``harness/window.py``).
``coded_mbps`` is every coded bit of its dispatches over its wall time,
``dispatch_ms_p95`` the 95th percentile of its dispatches' times. A sample
of its dispatches, drawn from the seed, is recorded as the engine produced
it. With ``--trace 1``, ``trace_dispatches`` more dispatches run under
``torch.profiler`` after the window and the per-layer metrics
(``metrics/*.py``) read that trace in place of the end-to-end ones.

Then the peak of device memory is read, the engine is freed, and the
plain reference (``reference/``) works the sampled dispatches out again
(``harness/judge.py``). Each number compared is printed beside its limit,
as the last lines on standard error and under ``checks``, the last key of
the result: one JSON line, the last of standard output.

The run refuses (exit code 2, no result) without as many CUDA cards as the
cell asks for, and fails (exit code 3, no result) if JAX or the JAX package
was loaded.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import random
import sys
import time

_IMPORTED = time.time()

import numpy as np  # noqa: E402
import torch  # noqa: E402

from ldpc_bench.harness import judge, spec, trace as traces, window  # noqa: E402
from ldpc_bench.reference import chain, code  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "informationbottleneckdecodingldpc_tpu"}
WARM_STEP = 1 << 40  # the set-up's dispatches draw steps far from the window's


def process_age() -> float:
    """Seconds since this process started (Linux), else since this module
    was imported."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time() - _IMPORTED


def graph_summary(H, config: dict, tables_path) -> dict:
    """Degree counts and table entries for the roofline."""
    from ldpc_bench.harness import roofline
    from ldpc_bench.reference.ib_decode import load_tables

    degrees = lambda nnz: {int(d): int(n) for d, n in zip(*np.unique(nnz, return_counts=True))}
    info = {"n_vars": H.shape[1], "check_degrees": degrees(H.getnnz(axis=1)),
            "var_degrees": degrees(H.getnnz(axis=0)),
            "alignment": bool(config["decoder"].get("message_alignment", False)),
            "table_elements": 0}
    if config["decoder"]["kind"] == "ib":
        tables = load_tables(str(tables_path))
        info["alignment"] = info["alignment"] and "matching_cn" in tables
        info["table_elements"] = roofline.table_elements(tables, info["alignment"])
    return info


def sample(seed: int, expected: int, k: int) -> list[int]:
    """``k`` dispatch indices drawn from the seed among the first four fifths
    of the dispatches the window is expected to complete."""
    pool = range(max(k, int(0.8 * expected)))
    return sorted(random.Random(seed).sample(pool, k))


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device: torch.device,
             program_hook=None) -> dict:
    """One run of ``cell`` (:func:`spec.workload`); ``program_hook(sim,
    tile)``, if given, changes the engine before the window (a test plants a
    fault, the control script puts the control in the decoder's place)."""
    from ldpc_bench.harness import program

    ages = [process_age()]
    config = cell["config_spec"]
    tables_path = spec.config_file(config["decoder"]["tables"]) if "tables" in config["decoder"] else None
    H = code.parity_check(config["code"])
    mc_seed = seed % 2**63
    sim = program.simulator(cell, H, str(tables_path) if tables_path else None, device, mc_seed)
    tile = program.exit_tile(sim)
    ages.append(process_age())
    if program_hook is not None:
        program_hook(sim, tile)
    ebn0, spd = float(cell["ebn0_db"]), sim.steps_per_dispatch
    warm = program.checkpoint(ebn0, WARM_STEP)
    window.dispatches(sim, warm, 1, [])
    t = time.perf_counter()
    window.dispatches(sim, warm, 1, [])
    expected = seconds / max(time.perf_counter() - t, 1e-6)
    recorder = window.Recorder(sim, 0, sample(seed, int(expected), cell["sample_dispatches"]))

    setup_s = process_age()
    print(f"setup {setup_s:.2f} s: start and imports {ages[0]:.2f}, engine {ages[1] - ages[0]:.2f}, "
          f"warm-up {setup_s - ages[1]:.2f}", file=sys.stderr)
    t0, marks, state = window.timed(sim, ebn0, 0, seconds, cell["dispatches_per_chunk"])
    window_s = marks[-1].t - t0
    in_window = len(marks)
    late = max(recorder.sample) + 1 - len(marks)
    if late > 0:  # answers due in the window, waited for after its close
        window.dispatches(sim, state, late, marks)

    result: dict = {"correct": False, "attempted": in_window, "failed": 0}
    if trace:
        metrics, result["breakdown"], busy_s, traced_s = traced(sim, recorder, state, cell, H,
                                                                 config, tables_path)
    else:
        times = window.dispatch_ms(t0, marks[:in_window])
        bits = marks[in_window - 1].blocks * sim.layout.n_vars
        metrics = {"coded_mbps": {"value": bits / window_s / 1e6, "unit": "Mbit/s"},
                   "dispatch_ms_p95": {"value": float(np.percentile(times, 95)), "unit": "ms"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
        print(f"dispatches {in_window} in {window_s:.3f} s, median {np.median(times):.4f} ms",
              file=sys.stderr)
    cuda = device.type == "cuda"
    result["metrics"] = metrics
    result["device"] = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
        "count": 1,
        "memory_peak_bytes": torch.cuda.max_memory_allocated(device) if cuda else 0,
    }
    if trace:
        result["device"].update(busy_s=busy_s, window_s=traced_s)

    records = recorder.records
    del sim, recorder
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    reference = chain.ReferenceChain(config, str(tables_path) if tables_path else None, H, device)
    checks, failed = judge.judge(reference, records, marks, seed=mc_seed, ebn0_db=ebn0, first_step=0,
                                 steps_per_dispatch=spd, batch=cell["batch"], chain=cell["chain"],
                                 tile=tile)
    print(f"reference check {time.perf_counter() - t_check:.2f} s", file=sys.stderr)
    result.update(correct=judge.holds(checks), failed=failed)
    result["checks"] = checks
    return result


def traced(sim, recorder, state, cell: dict, H, config: dict, tables_path):
    """``trace_dispatches`` dispatches under ``torch.profiler``: the
    per-layer metrics, the breakdown, the device's busy and window seconds."""
    from torch.profiler import ProfilerActivity, profile, record_function

    n = cell["trace_dispatches"]
    start = (state.blocks, state.iters_sum)
    recorder.spans = True
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(traces.WINDOW_SPAN):
            window.dispatches(sim, state, n, [])
    recorder.spans = False
    device, host = traces.from_profiler(prof)
    lo, hi = traces.window(host)
    blocks = state.blocks - start[0]
    readers = {m: spec.metric(m) for m in spec.names("metrics")}
    view = traces.Trace(device, host, lo, hi, steps=n * sim.steps_per_dispatch,
                        batch=sim.batch_per_device, mean_bodies=(state.iters_sum - start[1]) / blocks,
                        cell=cell, graph=graph_summary(H, config, tables_path), readers=readers)
    metrics = {}
    for m in spec.metrics_for(cell["name"]):
        value = view.value(m.NAME)
        if value is None:
            print(f"metric {m.NAME}: nothing to read in the trace", file=sys.stderr)
        else:
            metrics[m.NAME] = {"value": value, "unit": m.UNIT}
    return (metrics, traces.breakdown(device, host, lo, hi), view.busy_us / 1e6,
            view.window_us / 1e6)


def report(result: dict) -> None:
    """The numbers compared beside their limits, last on standard error."""
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} {'limit' if c['rule'] == '<=' else 'at least'} "
              f"{c['limit']}", file=sys.stderr)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = spec.workload(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); this host has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), device)
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
    if loaded:
        print(f"refused: these modules were loaded: {loaded}", file=sys.stderr)
        return 3
    report(result)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
