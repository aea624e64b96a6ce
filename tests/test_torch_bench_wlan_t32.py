"""The benchmark's |T| = 32 cell ``wlan_ib_t32.allzero_b2048`` on the CPU.

The plain IB reference (``ldpc_bench/reference/ib_decode.py``) on the
configuration ``wlan1296-ib-t32`` (the upstream's default |T| = 32, tables
designed at 0.6 dB) against the port's plain twin of K1 at K1's tile for
these tables, on the reference chain's own inputs: all-zeros at the cell's
0.6 dB, where every tile runs all 49 bodies, and encoded at 3.0 dB, where
tiles exit early. Then a whole run of the cell at batch 16 (one step, one
dispatch) that is correct, and not correct with the control (the reference
with 4 of the 5 bits of every message) in the decoder's place.
"""

import numpy as np
import pytest
import torch

from informationbottleneckdecodingldpc_torch.construct import DecoderConfig
from informationbottleneckdecodingldpc_torch.kernels.ib_lut_fused import FusedIBDecoder
from informationbottleneckdecodingldpc_torch.models import get_model
from ldpc_bench import control, run
from ldpc_bench.harness import spec
from ldpc_bench.reference import chain, code

CELL, CONFIG = "wlan_ib_t32.allzero_b2048", "wlan1296-ib-t32"
SEED = 2**31 + 11


@pytest.fixture(scope="module")
def port():
    config = spec.config(CONFIG)
    H = code.parity_check(config["code"])
    tables_path = str(spec.config_file(config["decoder"]["tables"]))
    layout = get_model(config["program"]["model"]).make_layout(H)
    decoder = FusedIBDecoder(layout, DecoderConfig.load(tables_path).tables)
    return chain.ReferenceChain(config, tables_path, H, "cpu"), decoder


@pytest.mark.parametrize("chain_kind, ebn0, batch, exits", [
    ("allzero", 0.6, 16, False),
    ("encoded", 3.0, 32, True),
])
def test_reference_equals_the_k1_twin(port, chain_kind, ebn0, batch, exits):
    ref, decoder = port
    tile = decoder.batch_tile
    assert tile == 16 and decoder.tables.cardinality_t_decoder == 32
    r = ref.steps(SEED, ebn0, [2], batch, chain_kind, tile)[0]
    got = decoder(r["input"])
    outputs, bodies = ref.decoder.decode(r["input"], tile)
    assert torch.equal(outputs, got.outputs)
    assert torch.equal(r["hard"], got.outputs < 16)
    assert np.float32(float(got.iterations)) == r["mean_bodies"]
    assert (int(bodies.min()) < decoder.imax - 1) == exits


def small() -> dict:
    cell = spec.workload(CELL)
    cell.update(batch=16, steps_per_dispatch=1, dispatches_per_chunk=1, sample_dispatches=1)
    return cell


@pytest.mark.parametrize("controlled", [False, True])
def test_run_is_correct_and_the_control_is_not(controlled):
    cell = small()
    hook = control.hook(cell) if controlled else None
    result = run.run_cell(cell, SEED, 0.5, False, torch.device("cpu"), program_hook=hook)
    assert result["correct"] != controlled, result["checks"]
    assert result["checks"]["dispatches_compared"]["value"] >= 1
    mismatch = result["checks"]["decision_mismatch"]["value"]
    assert (mismatch > 0) == controlled
