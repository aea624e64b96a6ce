"""The control of ``correct``: the plain reference decoder, computed one bit
of message precision below the configuration's, put in the decoder's place.

The configuration states |T|-level messages (4 bits at |T| = 16). The
control keeps log2(|T|) - 1 bits of every message a node sends (the
nearest precision below), decodes each step of the engine's own channel
input with it, and hands the engine its decisions and mean bodies; the
window, the counting, the readback and the judgement are the benchmark's
own. Every run of the control has to come out not correct.

    python3 -m ldpc_bench.control --workload <cell> --seeds 11,12,13 --seconds 5

prints each run's numbers compared and exits 1 if a control run came out
correct (the comparison would not see the control). Run on the card at the
cell's own size; the tests run it on the CPU at a small batch.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import types

import torch

from ldpc_bench import run
from ldpc_bench.harness import spec
from ldpc_bench.reference import chain, code


def hook(cell: dict, message_bits: int | None = None):
    """A ``program_hook`` that puts the control in the engine's decoder's place."""
    config = cell["config_spec"]
    tables = str(spec.config_file(config["decoder"]["tables"]))
    bits = message_bits or int(math.log2(config["decoder"]["t_decoder"])) - 1

    def install(sim, tile: int) -> None:
        decoder = chain.ReferenceChain(config, tables, code.parity_check(config["code"]), sim.device,
                                       message_bits=bits).decoder

        def decode(channel_input: torch.Tensor):
            batch = channel_input.shape[1]
            x = torch.nn.functional.pad(channel_input, (0, -batch % tile))
            outputs, bodies = decoder.decode(x, tile)
            inv = torch.full((), 1.0 / batch, dtype=torch.float32, device=channel_input.device)
            return types.SimpleNamespace(outputs=outputs[:, :batch],
                                         iterations=bodies[:batch].to(torch.float32).sum() * inv)

        sim.fused_decoder = decode

    return install


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=5.0)
    args = p.parse_args(argv)
    cell = spec.workload(args.workload)
    if not torch.cuda.is_available():
        print("the control runs on a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    seen = 0
    for seed in (int(s) for s in args.seeds.split(",")):
        result = run.run_cell(cell, seed, args.seconds, False, device, program_hook=hook(cell))
        readings = {k: c["value"] for k, c in result["checks"].items()}
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": result["correct"],
                          "checks": readings}), flush=True)
        seen += not result["correct"]
    return 0 if seen == len(args.seeds.split(",")) else 1


if __name__ == "__main__":
    sys.exit(main())
