"""The rank program of ``tests/test_torch_parallel.py``: one process of a
``torch.distributed`` group on the CPU (gloo), started by
``parallel.run_ranks`` (``torch.distributed.run``). It imports only the port.

  python -m torch.distributed.run --standalone --nproc-per-node <world> \\
      tests/torch_rank_jobs.py points <per-rank batch> <out.json>
  ... tests/torch_rank_jobs.py lockstep <inputs.npz> <out prefix>
  ... tests/torch_rank_jobs.py cli <rank 0's results> <other ranks' results> <CLI args>

``points`` runs every case of :data:`CASES` through ``run_point`` and, at
world 2, the fused twins against ``backend='xla'`` with early exit off and
the ``n_devices`` refusals; rank 0 writes the counters as JSON. ``lockstep``
decodes rank r's half of the batch in ``inputs.npz`` with the plain
whole-batch decoders and the all-reduced early exit, and writes
``<out prefix>.rank<r>.npz``. ``cli`` runs the port's sweep CLI with
``--multihost`` and the group named by its flags (``--coordinator-address``,
``--num-processes``, ``--process-id``, taken from the launcher's
environment), rank 0 on the first results file and the others on the
second."""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from informationbottleneckdecodingldpc_torch.codes import TannerGraph, regular_parity_check
from informationbottleneckdecodingldpc_torch.cli import simulate
from informationbottleneckdecodingldpc_torch.construct import build_decoder_config
from informationbottleneckdecodingldpc_torch.decode import (
    DecodeLayout,
    DeviceTrellis,
    belief_propagation_decode,
    ib_lut_decode,
    min_sum_decode,
)
from informationbottleneckdecodingldpc_torch.parallel import (
    initialize_multihost,
    make_mesh,
    psum_convergence_reduce,
)
from informationbottleneckdecodingldpc_torch.sim import BERSimulator

# tests/test_sim.py's small setup: a regular (3,6) code of 96 bits and a
# decoder designed at 2.5 dB.
CONFIG = dict(design_ebn0_db=2.5, cardinality_y_channel=400, cardinality_t_channel=16,
              cardinality_t_decoder=16, i_max=8, d_v=3, d_c=6)
FLOAT_ITERS = 8
SEED = 3
EBN0_DB = 2.5
GLOBAL_BATCH = 32
DISPATCHES = 3
TILE = 8  # the twins' tile: it divides every rank's shard (32, 16 and 8)
# (decoder, backend): the plain twins of K1 and K2 ('fused' on the CPU) and
# the whole-batch decoders ('xla').
CASES = [(d, b) for b in ("fused", "xla") for d in ("ib", "minsum")]
DECODERS = {"ib": ib_lut_decode, "minsum": min_sum_decode, "bp": belief_propagation_decode}


def setup():
    """The layout and the decoder's tables (the port's construction)."""
    H = regular_parity_check(96, 3, 6, seed=7)
    layout = DecodeLayout.from_graph(TannerGraph.from_check_matrix(H))
    return layout, build_decoder_config(**CONFIG).tables


def simulator(layout, tables, decoder: str, backend: str, batch: int, n_devices=None,
              early_exit: bool = True) -> BERSimulator:
    kw = dict(trellis=DeviceTrellis.from_tables(tables, "cpu")) if decoder == "ib" else dict(
        max_iters=FLOAT_ITERS)
    return BERSimulator(
        layout, decoder, device="cpu", chain="allzero", count_all_bits=True, seed=SEED,
        batch_per_device=batch, n_devices=n_devices, backend=backend, early_exit=early_exit,
        batch_tile=TILE if backend == "fused" else None, **kw,
    )


def point(sim: BERSimulator) -> list:
    """(errors, frame errors, blocks, mean iterations) of DISPATCHES dispatches."""
    r = sim.run_point(EBN0_DB, min_errors=10**9, max_blocks=DISPATCHES * sim.batch_total)
    return [r.errors, r.frame_errors, r.blocks, r.mean_iterations]


def points(batch: int, world: int) -> dict:
    """Every case's point at ``batch`` codewords per rank; at world 2 also
    the twins with early exit off and the refusals of other ``n_devices``."""
    layout, tables = setup()
    out = {f"{d}-{b}": point(simulator(layout, tables, d, b, batch)) for d, b in CASES}
    if world == 2:
        for d in ("ib", "minsum"):
            for b in ("fused", "xla"):
                out[f"{d}-{b}-no-exit"] = point(
                    simulator(layout, tables, d, b, batch, early_exit=False))
        refused = []
        for n in (1, 3):
            try:
                simulator(layout, tables, "minsum", "xla", batch, n_devices=n)
            except ValueError as e:
                refused.append(str(e))
        out["refused"] = refused
    return out


def lockstep(inputs: str, prefix: str, rank: int, world: int) -> None:
    """Rank ``rank``'s columns of each input, decoded with the all-reduced
    early exit."""
    layout, tables = setup()
    reduce = psum_convergence_reduce(make_mesh(world, "cpu"))
    trellis = DeviceTrellis.from_tables(tables, "cpu")
    out = {}
    with np.load(inputs) as z:
        for name, fn in DECODERS.items():
            x = z["clusters" if name == "ib" else "llrs"]
            half = x.shape[1] // world
            x = torch.from_numpy(x[:, rank * half:(rank + 1) * half].copy())
            if name == "ib":
                res = fn(layout, trellis, x, convergence_reduce=reduce)
            else:
                res = fn(layout, x, FLOAT_ITERS, convergence_reduce=reduce)
            out[f"{name}_outputs"] = res.outputs.numpy()
            out[f"{name}_iterations"] = np.asarray(int(res.iterations))
            out[f"{name}_unsatisfied"] = res.unsatisfied.numpy()
    np.savez(f"{prefix}.rank{rank}.npz", **out)


def cli(rank0_results: str, other_results: str, argv: list[str]) -> None:
    """The sweep CLI as one rank, the group given by its flags."""
    env = os.environ
    rank = env["RANK"]
    simulate.main([*argv, "--results", rank0_results if rank == "0" else other_results,
                   "--multihost", "--coordinator-address",
                   f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
                   "--num-processes", env["WORLD_SIZE"], "--process-id", rank])


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("job", choices=["points", "lockstep", "cli"])
    p.add_argument("args", nargs=argparse.REMAINDER)
    a = p.parse_args()
    if a.job == "cli":
        cli(a.args[0], a.args[1], a.args[2:])
        return
    rank, world = initialize_multihost(backend="gloo")
    if a.job == "points":
        out = points(int(a.args[0]), world)
        if rank == 0:
            with open(a.args[1], "w") as f:
                json.dump(out, f)
    else:
        lockstep(a.args[0], a.args[1], rank, world)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
