"""A whole run on the CPU at a small batch, with the port's plain twins in
the engine: a sound run is correct; the control and each fault the cells
can have, planted under the timed path, make it not correct.

The faults: a step that returns its state unchanged (the decoder hands back
its input), half of the batch left out with the mean taken over the rest,
and an answer altered where it is produced (one decision flipped each
step). The cells run on one card, so there is no exchange between cards to
leave out.
"""

import types

import pytest
import torch

from ldpc_bench import control, run
from ldpc_bench.harness import spec

SEED = 2**31 + 7


def small(name: str, batch: int = 32, steps: int = 2) -> dict:
    cell = spec.workload(name)
    cell.update(batch=batch, steps_per_dispatch=steps, dispatches_per_chunk=1, sample_dispatches=1)
    return cell


def planted(fault: str):
    def install(sim, tile):
        inner = sim.fused_decoder
        t = sim.trellis.t_decoder

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
            res = inner(channel_input)
            outputs = res.outputs.clone()
            outputs[0, 0] = t - 1 - outputs[0, 0]
            return types.SimpleNamespace(outputs=outputs, iterations=res.iterations)

        sim.fused_decoder = decode

    return install


def test_sound_run_is_correct():
    result = run.run_cell(small("wlan_ib.allzero_b4096"), SEED, 0.5, False, torch.device("cpu"))
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {"coded_mbps", "dispatch_ms_p95", "setup_s"}


def test_sound_encoded_run_is_correct():
    result = run.run_cell(small("wlan_ib.queue_enc512", batch=48), SEED, 0.5, False,
                          torch.device("cpu"))
    assert result["correct"], result["checks"]
    assert result["checks"]["codeword_mismatch"]["value"] == 0


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "altered_answer"])
def test_fault_is_not_correct(fault):
    result = run.run_cell(small("wlan_ib.allzero_b4096"), SEED, 0.5, False, torch.device("cpu"),
                          program_hook=planted(fault))
    assert not result["correct"], result["checks"]
    assert result["failed"] >= 1


def test_control_is_not_correct():
    cell = small("wlan_ib.allzero_b4096")
    result = run.run_cell(cell, SEED, 0.5, False, torch.device("cpu"), program_hook=control.hook(cell))
    assert not result["correct"]
    assert result["checks"]["decision_mismatch"]["value"] > 0
