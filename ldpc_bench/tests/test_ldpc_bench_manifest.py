"""``BENCHMARK.json`` and the files it names: keys, names, units, and that
every cell resolves its configuration and every metric its reader."""

import json
import re

import pytest

from ldpc_bench.harness import spec

MANIFEST = json.loads((spec.ROOT.parent / "BENCHMARK.json").read_text())
TEXT = re.compile(r"[^\t\n]{1,200}")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", *KEYS}
    assert 1 <= len(MANIFEST["paths"]) <= 16
    for p in MANIFEST["paths"]:
        assert PATH.fullmatch(p) and not p.startswith("/") and ".." not in p.split("/")
    assert 1 <= len(MANIFEST["command"]) <= 32 and all(TEXT.fullmatch(w) for w in MANIFEST["command"])
    assert isinstance(MANIFEST["run_seconds"], int) and 1 <= MANIFEST["run_seconds"] <= 51
    assert len(json.dumps(MANIFEST)) <= 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries(section):
    entries = MANIFEST[section]
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        assert set(e) - {"workloads"} == KEYS[section], e
        assert spec.NAME.fullmatch(e["name"]), e["name"]
        if "unit" in e:
            assert spec.UNIT.fullmatch(e["unit"]) and e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert TEXT.fullmatch(e[key]), e[key]


def test_bounds_and_sources():
    for m in MANIFEST["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in MANIFEST["end_to_end"]}
    for m in MANIFEST["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_configs_resolve():
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(set(files)) == len(files)
    used = {w["config"] for w in MANIFEST["workloads"]}
    for c in MANIFEST["configs"]:
        assert c["name"] in used
        assert c["file"] == f"ldpc_bench/configs/{c['name']}.json"
        body = spec.config(c["name"])
        assert body["source"] == c["source"] and body["reduced"] == c["reduced"] == []
        assert body["assumed"] and body["guarantees"]
        assert spec.config_file(body["decoder"]["tables"]).is_file()


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_workloads_resolve(cell):
    entry = next(w for w in MANIFEST["workloads"] if w["name"] == cell)
    body = spec.workload(cell)
    assert (body["config"], body["traffic"], body["chips"]) == (entry["config"], entry["traffic"], entry["chips"])
    assert body["chips"] == 1 and body["chain"] in ("allzero", "encoded")
    assert body["batch"] > 0 and body["steps_per_dispatch"] & (body["steps_per_dispatch"] - 1) == 0
    assert spec.NAME.fullmatch(body["traffic"])


def test_pairs_are_unique():
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(set(pairs)) == len(pairs)


@pytest.mark.parametrize("metric", [m["name"] for m in MANIFEST["per_layer"]])
def test_metrics_resolve(metric):
    entry = next(m for m in MANIFEST["per_layer"] if m["name"] == metric)
    module = spec.metric(metric)
    assert (module.UNIT, module.LAYER, module.MOVES) == (entry["unit"], entry["layer"], entry["moves"])
    assert module.WORKLOADS == entry.get("workloads")
    assert callable(module.read)
    assert entry["moves"] in {m["name"] for m in MANIFEST["end_to_end"]}


def test_every_file_is_in_the_manifest():
    assert spec.names("workloads") == sorted(w["name"] for w in MANIFEST["workloads"])
    assert spec.names("configs") == sorted(c["name"] for c in MANIFEST["configs"])
    assert spec.names("metrics") == sorted(m["name"] for m in MANIFEST["per_layer"])
