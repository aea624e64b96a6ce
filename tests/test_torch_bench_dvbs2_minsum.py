"""The benchmark's min-sum cell ``dvbs2_minsum.allzero_b1024`` on the CPU.

The plain min-sum reference (``ldpc_bench/reference/minsum_decode.py``)
against the port's plain twin of K2 and K4 (``float_decode_tiled``) on
seeded channel LLRs, the WLAN and DVB-S2 codes, with tiles that exit early
at the higher Eb/N0; a whole run of the cell at batch 8 (one step, one
dispatch, tiles of 4 in the engine) that is correct, and not correct with
each fault planted under the timed path or with the control (the reference
with messages rounded to bfloat16's 8 significant bits) in the decoder's
place; and the reference's imports.
"""

import ast
import copy
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from informationbottleneckdecodingldpc_torch.kernels import float_hbm
from informationbottleneckdecodingldpc_torch.kernels.float_fused import float_decode_tiled
from informationbottleneckdecodingldpc_torch.models import get_model
from ldpc_bench import run
from ldpc_bench.harness import spec
from ldpc_bench.reference import chain, code, minsum_decode

CELL, CONFIG = "dvbs2_minsum.allzero_b1024", "dvbs2-64800-minsum-t16"
SEED = 2**31 + 7


def minsum_config(name: str) -> dict:
    """A configuration's code under the min-sum cell's decoder and channel."""
    config = copy.deepcopy(spec.config(name))
    minsum = spec.config(CONFIG)
    config.update(decoder=minsum["decoder"], channel=minsum["channel"])
    return config


@pytest.mark.parametrize("name,batch,tile,ebn0,chain_kind,exits", [
    ("wlan1296-ib-t16", 16, 4, 1.0, "allzero", False),
    ("wlan1296-ib-t16", 16, 4, 3.0, "encoded", True),
    (CONFIG, 8, 4, 1.0, "allzero", False),
    (CONFIG, 8, 4, 2.0, "allzero", True),
])
def test_reference_equals_the_port_twin(name, batch, tile, ebn0, chain_kind, exits):
    config = minsum_config(name)
    H = code.parity_check(config["code"])
    ref = chain.ReferenceChain(config, None, H, "cpu")
    r = ref.steps(SEED, ebn0, [3], batch, chain_kind, tile)[0]
    layout = get_model(config["program"]["model"]).make_layout(H)
    port = float_decode_tiled(layout, r["input"], "minsum", tile, config["decoder"]["i_max"])
    outputs, bodies = ref.decoder.decode(r["input"], tile)
    assert torch.equal(r["hard"], port.outputs < 0)
    assert torch.equal(outputs, port.outputs)
    assert np.float32(float(port.iterations)) == r["mean_bodies"]
    assert (int(bodies.min()) < config["decoder"]["i_max"] - 1) == exits


def small(monkeypatch) -> dict:
    """The cell at batch 8, one step a dispatch, one dispatch a chunk and
    sampled, in an engine whose K4 twin exits in tiles of 4."""
    monkeypatch.setattr(float_hbm, "HBM_BATCH_TILE", 4)
    cell = spec.workload(CELL)
    cell.update(batch=8, steps_per_dispatch=1, dispatches_per_chunk=1, sample_dispatches=1)
    return cell


def planted(fault: str):
    def install(sim, tile):
        inner = sim.fused_decoder
        assert tile == 4
        if fault == "control":
            config = spec.config(CONFIG)
            control = chain.ReferenceChain(config, None, code.parity_check(config["code"]), sim.device,
                                           message_bits=8).decoder

        def decode(channel_input):
            batch = channel_input.shape[1]
            if fault == "state_unchanged":
                return types.SimpleNamespace(outputs=channel_input.clone(),
                                             iterations=torch.zeros((), dtype=torch.float32))
            if fault == "half_batch":
                res = inner(channel_input[:, : batch // 2])
                return types.SimpleNamespace(
                    outputs=torch.cat([res.outputs, channel_input[:, batch // 2:]], dim=1),
                    iterations=res.iterations)
            if fault == "control":
                outputs, bodies = control.decode(channel_input, tile)
                inv = torch.full((), 1.0 / batch, dtype=torch.float32)
                return types.SimpleNamespace(outputs=outputs,
                                             iterations=bodies.to(torch.float32).sum() * inv)
            res = inner(channel_input)
            outputs = res.outputs.clone()
            outputs[0, 0] = 1.0 if outputs[0, 0] < 0 else -1.0
            return types.SimpleNamespace(outputs=outputs, iterations=res.iterations)

        sim.fused_decoder = decode

    return install


def test_sound_run_is_correct(monkeypatch):
    result = run.run_cell(small(monkeypatch), SEED, 0.5, False, torch.device("cpu"))
    assert result["correct"], result["checks"]
    assert result["checks"]["dispatches_compared"]["value"] >= 1
    assert all(c["value"] == 0 for k, c in result["checks"].items() if k != "dispatches_compared")
    assert set(result["metrics"]) == {"coded_mbps", "dispatch_ms_p95", "setup_s"}


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "altered_answer", "control"])
def test_fault_is_not_correct(monkeypatch, fault):
    result = run.run_cell(small(monkeypatch), SEED, 0.5, False, torch.device("cpu"),
                          program_hook=planted(fault))
    assert not result["correct"], result["checks"]
    assert result["failed"] >= 1
    assert result["checks"]["decision_mismatch"]["value"] > 0


def test_reference_imports_neither_the_port_nor_jax():
    tree = ast.parse(Path(minsum_decode.__file__).read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            assert node.level in (0, 1)
            if node.level == 0:
                names.add(node.module.split(".")[0])
    assert names <= {"__future__", "torch"}, names
