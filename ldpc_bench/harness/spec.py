"""Find a cell, its configuration and the per-layer metrics by name.

Everything that belongs to one configuration, one cell or one per-layer
metric sits in a file of its own, which this module finds by the name
``BENCHMARK.json`` uses:

- ``configs/<config>.json``: the deployment (code, decoder, channel) and the
  files it names beside it;
- ``workloads/<cell>.json``: the configuration, the traffic (chain, Eb/N0,
  batch, steps a dispatch) and the harness's own settings for the cell;
- ``metrics/<metric>.py``: the reader of one per-layer metric with its unit,
  layer, the end-to-end metric it moves and the cells it reads in.

A new cell, configuration or metric is a new file; no existing file changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")

WORKLOAD_KEYS = {"config", "traffic", "chips", "chain", "ebn0_db", "batch", "steps_per_dispatch",
                 "backend", "dispatches_per_chunk", "sample_dispatches", "trace_dispatches"}


def check_name(name: str) -> str:
    if not NAME.fullmatch(name):
        raise ValueError(f"{name!r} is not a benchmark name")
    return name


def _json(kind: str, name: str) -> dict:
    path = ROOT / kind / f"{check_name(name)}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


def workload(name: str) -> dict:
    """A cell's file, with its configuration's file under ``config_spec``."""
    w = _json("workloads", name)
    missing = WORKLOAD_KEYS - set(w)
    if missing:
        raise ValueError(f"workload {name!r} lacks {sorted(missing)}")
    return {**w, "name": name, "config_spec": config(w["config"])}


def config(name: str) -> dict:
    c = _json("configs", name)
    if c.get("name") != name:
        raise ValueError(f"configs/{name}.json names itself {c.get('name')!r}")
    return c


def config_file(relative: str) -> Path:
    """A file a configuration names, beside its JSON file."""
    return ROOT / "configs" / relative


def names(kind: str) -> list[str]:
    """The names of every file of ``kind`` (configs, workloads, metrics)."""
    suffix = ".py" if kind == "metrics" else ".json"
    return sorted(p.name[: -len(suffix)] for p in (ROOT / kind).glob(f"*{suffix}")
                  if not p.name.startswith("_"))


def metric(name: str):
    """The module of a per-layer metric: ``UNIT``, ``LAYER``, ``MOVES``,
    ``WORKLOADS`` (None: every cell) and ``read(trace)``."""
    path = ROOT / "metrics" / f"{check_name(name)}.py"
    spec = importlib.util.spec_from_file_location(f"ldpc_bench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module.NAME = name
    return module


def metrics_for(cell: str) -> list:
    """The per-layer metrics a cell reports."""
    out = []
    for name in names("metrics"):
        m = metric(name)
        if m.WORKLOADS is None or cell in m.WORKLOADS:
            out.append(m)
    return out
