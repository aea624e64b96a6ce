"""Data-parallel dry run: one Monte-Carlo dispatch through the fused IB
decoder under ``torch.distributed``, at a world size the caller picks.

The counterpart of the JAX package's ``__graft_entry__.py``
``dryrun_multichip``: a structured regular (3,6) quasi-cyclic code of 96
bits (``regular_qc_parity_check(96, 3, 6, seed=7)``), a decoder built by the
port's own construction (design 2.0 dB, |T| = 16, i_max 4, 400 channel
levels), ``backend='fused'`` (K1 on a card, its twin on the CPU), 8
codewords per rank and one dispatch, the counters all-reduced. Rank 0
prints ``dryrun_multichip(<world>): ok, ...``.

Usage (``--world`` ranks are started with ``torch.distributed.run``; a
process that ``RANK`` marks as one of its ranks runs the dry run itself):
  python -m informationbottleneckdecodingldpc_torch.cli.dryrun --world 2 --device cpu
  python -m informationbottleneckdecodingldpc_torch.cli.dryrun --world 1 --device cuda
"""

from __future__ import annotations

import argparse
import os

import torch

from ..codes import TannerGraph, regular_qc_parity_check
from ..construct import build_decoder_config
from ..decode import DecodeLayout, DeviceTrellis
from ..kernels import philox_planes
from ..parallel.mesh import default_backend, initialize_multihost, run_ranks
from ..sim import BERSimulator
from ..sim.engine import resolve_device

BATCH_PER_RANK = 8


def dryrun_multichip(device: torch.device) -> str:
    """One dispatch of the dry run's simulator on this rank's ``device`` in
    the initialised process group; the line rank 0 prints (with this rank's
    launches of K1 and of the channel-input kernel, 0 on the CPU)."""
    H = regular_qc_parity_check(96, 3, 6, seed=7)
    layout = DecodeLayout.from_graph(TannerGraph.from_check_matrix(H))
    cfg = build_decoder_config(
        design_ebn0_db=2.0, cardinality_y_channel=400, cardinality_t_channel=16,
        cardinality_t_decoder=16, i_max=4, d_v=3, d_c=6,
    )
    sim = BERSimulator(
        layout, "ib", device=device, trellis=DeviceTrellis.from_tables(cfg.tables, device),
        chain="allzero", count_all_bits=True, batch_per_device=BATCH_PER_RANK,
        n_devices=None, seed=0, backend="fused",
    )
    result = sim.run_point(2.0, min_errors=1, max_blocks=sim.batch_total)
    if result.blocks != sim.batch_total:
        raise RuntimeError(f"the dry run decoded {result.blocks} codewords, not {sim.batch_total}")
    return (
        f"dryrun_multichip({sim.n_devices}): ok, BER={result.ber:.3e} over {result.blocks} "
        f"codewords on {sim.n_devices} rank(s) ({type(sim.fused_decoder).__name__} on "
        f"{device.type}, {torch.distributed.get_backend()}; kernel launches "
        f"{sim.fused_decoder.launches}, channel-input launches "
        f"{sum(philox_planes.launches.values())})"
    )


def main(argv=None) -> str:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    p.add_argument("--world", type=int, default=2, help="ranks to start")
    p.add_argument("--device", default="cuda",
                   help="cpu (gloo) or cuda (NCCL; a rank takes card LOCAL_RANK mod cards)")
    p.add_argument("--timeout", type=float, default=300.0, help="seconds for all ranks")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    if "RANK" not in os.environ:
        out = run_ranks(args.world, ["-m", __spec__.name, "--device", args.device], args.timeout)
        line = next(ln for ln in out.splitlines() if ln.startswith("dryrun_multichip("))
        print(line, flush=True)
        return line
    rank, _ = initialize_multihost(backend=default_backend(device))
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    line = dryrun_multichip(device)
    if rank == 0:
        print(line, flush=True)
    torch.distributed.destroy_process_group()
    return line


if __name__ == "__main__":
    main()
