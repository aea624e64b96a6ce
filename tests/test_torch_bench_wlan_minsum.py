"""The benchmark's WLAN min-sum cell ``wlan_minsum.allzero_b4096`` on the CPU.

The plain min-sum reference (``ldpc_bench/reference/minsum_decode.py``)
against the port's plain twin of K2 (``float_decode_tiled``) at K2's own
WLAN tile of 5 codewords, on the reference chain's own inputs at a batch
that leaves a padded last tile: at an Eb/N0 where no tile exits and at the
cell's 2.0 dB, where tiles exit after different bodies. Then a whole run of
the cell at a small batch with a partial tile that is correct, and not
correct with the control (the reference with messages at bfloat16's 8
significant bits) or a planted fault in the decoder's place; and the
configuration's code block, that of ``wlan1296-ib-t16``, uncut.
"""

import json
import types

import numpy as np
import pytest
import torch

from informationbottleneckdecodingldpc_torch.kernels.float_fused import (
    float_decode_tiled,
    pick_float_batch_tile,
)
from informationbottleneckdecodingldpc_torch.models import get_model
from ldpc_bench import run
from ldpc_bench.harness import spec
from ldpc_bench.reference import chain, code

CELL, CONFIG = "wlan_minsum.allzero_b4096", "wlan1296-minsum-t16"
SEED = 2**31 + 28


@pytest.fixture(scope="module")
def setting():
    config = spec.config(CONFIG)
    H = code.parity_check(config["code"])
    layout = get_model(config["program"]["model"]).make_layout(H)
    return config, chain.ReferenceChain(config, None, H, "cpu"), layout


@pytest.mark.parametrize("ebn0, exits", [(0.5, False), (2.0, True)])
def test_reference_equals_the_k2_twin_at_its_tile(setting, ebn0, exits):
    config, ref, layout = setting
    tile, batch = pick_float_batch_tile(layout), 23
    assert tile == 5 and batch % tile
    r = ref.steps(SEED, ebn0, [4], batch, "allzero", tile)[0]
    port = float_decode_tiled(layout, r["input"], "minsum", tile, config["decoder"]["i_max"])
    outputs, bodies = ref.decoder.decode(torch.nn.functional.pad(r["input"], (0, -batch % tile)), tile)
    assert torch.equal(outputs[:, :batch], port.outputs)
    assert torch.equal(r["hard"], port.outputs < 0)
    assert np.float32(float(port.iterations)) == r["mean_bodies"]
    per_tile = bodies.view(-1, tile)[:, 0]
    full = config["decoder"]["i_max"] - 1
    assert (int(per_tile.min()) < full) == exits
    if exits:  # tiles leave after different bodies, the padded one among them
        assert len(set(per_tile.tolist())) > 1


def small() -> dict:
    """The cell at batch 12 (two tiles of 5 and a padded third), two steps
    a dispatch, one dispatch a chunk and sampled."""
    cell = spec.workload(CELL)
    cell.update(batch=12, steps_per_dispatch=2, dispatches_per_chunk=1, sample_dispatches=1)
    return cell


def planted(fault: str):
    """A ``program_hook`` that puts a fault, or the control, in K2's place."""

    def install(sim, tile):
        inner = sim.fused_decoder
        assert tile == 5
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
                x = torch.nn.functional.pad(channel_input, (0, -batch % tile))
                outputs, bodies = control.decode(x, tile)
                inv = torch.full((), 1.0 / batch, dtype=torch.float32)
                return types.SimpleNamespace(outputs=outputs[:, :batch],
                                             iterations=bodies[:batch].to(torch.float32).sum() * inv)
            res = inner(channel_input)
            outputs = res.outputs.clone()
            outputs[0, batch - 1] = 1.0 if outputs[0, batch - 1] < 0 else -1.0
            return types.SimpleNamespace(outputs=outputs, iterations=res.iterations)

        sim.fused_decoder = decode

    return install


def test_sound_run_is_correct():
    result = run.run_cell(small(), SEED, 0.5, False, torch.device("cpu"))
    assert result["correct"], result["checks"]
    assert result["checks"]["dispatches_compared"]["value"] >= 1
    assert all(c["value"] == 0 for k, c in result["checks"].items() if k != "dispatches_compared")


@pytest.mark.parametrize("fault", ["control", "state_unchanged", "half_batch", "altered_answer"])
def test_fault_is_not_correct(fault):
    result = run.run_cell(small(), SEED, 0.5, False, torch.device("cpu"), program_hook=planted(fault))
    assert not result["correct"], result["checks"]
    assert result["failed"] >= 1
    assert result["checks"]["decision_mismatch"]["value"] > 0


@pytest.mark.parametrize("check", ["code_block", "uncut", "manifest"])
def test_configuration_is_the_wlan_code_uncut(check):
    config = spec.config(CONFIG)
    if check == "code_block":
        assert config["code"] == spec.config("wlan1296-ib-t16")["code"]
    elif check == "uncut":
        assert config["reduced"] == [] and "tables" not in config["decoder"]
        assert config["decoder"] == {"kind": "minsum", "i_max": 50, "early_exit": True}
        assert config["channel"]["cardinality_t"] == 16
    else:
        manifest = json.loads((spec.ROOT.parent / "BENCHMARK.json").read_text())
        entry = next(c for c in manifest["configs"] if c["name"] == CONFIG)
        assert entry["source"] == config["source"] and entry["reduced"] == []
        cell = next(w for w in manifest["workloads"] if w["name"] == CELL)
        assert (cell["config"], cell["chips"]) == (CONFIG, 1)
