"""Run a BER sweep: the IB, min-sum or BP decoder on the all-zeros or encoded
chain, BPSK or M-ary, resumable, with optional .npz, .mat and plot exports.

Port of ``cli/simulate.py`` on ``SweepController`` and ``SweepSchedule``:
Eb/N0 from ``--start-db`` in steps of ``--step-db`` until the BER reaches
``--target-ber`` or Eb/N0 ``--max-db``; the results file is rewritten after
every point (and mid-point every 50 steps), and a rerun with the same file
resumes after the last completed point. ``--modulation qam<M>|psk<M>`` runs
the encoded chain through the QAM or M-PSK map and the exact soft demapper
into a float decoder (it implies ``--llr-source true``). ``--trace-dir``
writes a ``torch.profiler`` trace of the sweep. The default device is
``cuda``; without a card the run raises.

``--multihost`` runs the sweep data-parallel, one process per card: each
process joins the ``torch.distributed`` group (``--coordinator-address
host:port``, ``--num-processes``, ``--process-id``, or the ``MASTER_ADDR``
/ ``MASTER_PORT`` / ``RANK`` / ``WORLD_SIZE`` environment) and prints
``multihost: process r/world``; rank r decodes its ``--batch-per-device``
shard of each step and the counters are all-reduced. The backend follows
the device (``nccl`` for CUDA, ``gloo`` for the CPU) unless
``--dist-backend`` names one (``gloo`` lets several ranks share one card).
A rank's device is ``cuda:<LOCAL_RANK mod cards>`` (``LOCAL_RANK`` defaults
to the rank) unless ``--device`` names one. Process 0 reads the results
file and broadcasts it, so every rank resumes from the same state; only
process 0 writes results, checkpoints and exports. ``--n-devices`` must be
the world size when given.

Usage:
  python -m informationbottleneckdecodingldpc_torch.cli.simulate \\
      --model wlan-1296 --config results/configs/wlan_T16_0.8.npz \\
      --start-db 0.8 --max-db 1.6 --step-db 0.4 --results wlan_ib.json
  python -m informationbottleneckdecodingldpc_torch.cli.simulate \\
      --model wlan-1296 --decoder minsum --chain encoded --modulation qam16 \\
      --start-db 1.0 --max-db 4.5 --min-errors 7000 --batch-per-device 512 \\
      --steps-per-dispatch 8 --seed 33 --results wlan_minsum_qam16.json \\
      --export-npz wlan_minsum_qam16.npz
  python -m informationbottleneckdecodingldpc_torch.cli.simulate \\
      --model wlan-1296 --decoder minsum --chain encoded --modulation psk8 \\
      --start-db 1.5 --max-db 5.0 --min-errors 7000 --batch-per-device 512 \\
      --steps-per-dispatch 8 --seed 34 --results wlan_minsum_psk8.json
  python -m informationbottleneckdecodingldpc_torch.cli.simulate \\
      --model dvbs2-64800 --config results/configs/dvbs2_T16_0.6.npz \\
      --chain encoded --start-db 0.9 --max-db 1.1 --batch-per-device 1024 \\
      --results dvbs2_ib.json
  # two gloo ranks on the CPU, each decoding 8 of a step's 16 codewords:
  python -m torch.distributed.run --standalone --nproc-per-node 2 \\
      -m informationbottleneckdecodingldpc_torch.cli.simulate \\
      --model regular-3-6-504 --decoder minsum --device cpu --max-iters 4 \\
      --start-db 3.0 --max-db 3.1 --min-errors 5 --batch-per-device 8 \\
      --max-blocks-per-point 64 --results mh.json --multihost

DVB-S2 N=64800 does not fit the shared-memory kernels, so the engine's
``backend='auto'`` decodes it with the device-memory kernels K3 (IB) and K4
(min-sum, BP).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re

import torch

from ..construct import DecoderConfig
from ..decode import DeviceTrellis
from ..encode import LDPCEncoder
from ..models import get_model
from ..parallel.mesh import default_backend, initialize_multihost, make_mesh
from ..sim import BERSimulator, SweepController, SweepSchedule
from ..sim.engine import resolve_device
from ..sim.results import export_mat, export_npz, export_plot
from ..utils.profiling import device_trace


def parse_modulation(p: argparse.ArgumentParser, text: str) -> tuple[str, int]:
    """``bpsk``, ``qam<M>`` or ``psk<M>`` -> (modulation, order): sqrt(M)
    for QAM, M for M-PSK; an unknown name or order is a usage error."""
    if text == "bpsk":
        return "bpsk", 2
    m = re.fullmatch(r"(qam|psk)(\d+)", text)
    if not m:
        p.error(f"unrecognized --modulation {text!r}")
    order = int(m.group(2))
    if order < 4 or (order & (order - 1)):
        p.error("modulation order must be a power of two >= 4")
    if m.group(1) == "psk":
        return "mpsk", order
    sqrt_m = math.isqrt(order)
    if sqrt_m * sqrt_m != order:
        p.error("qam order must be a perfect square (square QAM)")
    return "qam", sqrt_m


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    p.add_argument("--model", required=True)
    p.add_argument("--decoder", choices=["ib", "minsum", "bp"], default="ib")
    p.add_argument("--config", default=None, help="decoder config .npz (ib)")
    p.add_argument("--chain", choices=["allzero", "encoded"], default="allzero")
    p.add_argument("--llr-source", choices=["quantized", "true"], default="quantized")
    p.add_argument("--modulation", default="bpsk",
                   help="bpsk (default) | qam<M> | psk<M>, e.g. qam16, psk8; M-ary runs the "
                        "encoded chain into a float decoder through the exact soft demapper "
                        "(implies --llr-source true)")
    p.add_argument("--start-db", type=float, default=0.0)
    p.add_argument("--max-db", type=float, default=None)
    p.add_argument("--step-db", type=float, default=0.1)
    p.add_argument("--target-ber", type=float, default=1e-6)
    p.add_argument("--min-errors", type=int, default=None)
    p.add_argument("--max-blocks-per-point", type=int, default=None,
                   help="cap Monte-Carlo blocks per Eb/N0 point")
    p.add_argument("--max-iters", type=int, default=None)
    p.add_argument("--t-channel", type=int, default=None,
                   help="channel-quantizer cardinality |T_ch| for the float decoders "
                        "(default: the model's)")
    p.add_argument("--batch-per-device", type=int, default=None)
    p.add_argument("--steps-per-dispatch", type=int, default=1,
                   help="Monte-Carlo steps per dispatch (counters unchanged)")
    p.add_argument("--no-early-exit", action="store_true")
    p.add_argument("--results", required=True, help="JSON results (the resume point)")
    p.add_argument("--export-npz", default=None)
    p.add_argument("--export-mat", default=None)
    p.add_argument("--export-plot", default=None, help="BER curve (pdf/png)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--trace-dir", default=None,
                   help="write a torch.profiler Chrome trace of the sweep here")
    p.add_argument("--device", default=None,
                   help="default: cuda (with --multihost cuda:<LOCAL_RANK mod cards>)")
    p.add_argument("--n-devices", type=int, default=None,
                   help="the world size (default: the process group's, 1 without one)")
    p.add_argument("--multihost", action="store_true",
                   help="join the torch.distributed group first (one process per card)")
    p.add_argument("--coordinator-address", default=None,
                   help="host:port of rank 0's rendezvous (default: MASTER_ADDR/MASTER_PORT)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--dist-backend", choices=["nccl", "gloo"], default=None,
                   help="default: nccl for a CUDA device, gloo for the CPU")
    args = p.parse_args(argv)

    device = resolve_device(args.device or "cuda")
    is_primary, resume_state = True, None
    if args.multihost:
        rank, world = initialize_multihost(
            args.coordinator_address, args.num_processes, args.process_id,
            args.dist_backend or default_backend(device),
        )
        if device.type == "cuda" and args.device is None:
            local = int(os.environ.get("LOCAL_RANK", rank))
            device = torch.device("cuda", local % torch.cuda.device_count())
        if device.type == "cuda":
            torch.cuda.set_device(device)
        print(f"multihost: process {rank}/{world}", flush=True)
        is_primary = rank == 0
        if world > 1:
            # Every rank must run the same sweep (each dispatch all-reduces),
            # so all resume from process 0's results file.
            resume_state = broadcast_resume_state(make_mesh(world, device), args.results)
    spec = get_model(args.model)
    H = spec.make_h()
    trellis = None
    cardinality_t_channel = spec.cardinality_t_channel
    if args.decoder == "ib":
        if not args.config:
            p.error("--config is required for the ib decoder")
        cfg = DecoderConfig.load(args.config)
        trellis = DeviceTrellis.from_tables(cfg.tables, device)
        cardinality_t_channel = cfg.tables.cardinality_t_channel
    if args.t_channel is not None:
        if args.decoder == "ib":
            p.error("--t-channel applies to the float decoders only (the ib decoder's "
                    "|T_ch| comes from its config)")
        cardinality_t_channel = args.t_channel
    modulation, mod_order = parse_modulation(p, args.modulation)
    llr_source = "true" if modulation != "bpsk" else args.llr_source
    encoder = LDPCEncoder(H) if args.chain == "encoded" else None

    sim = BERSimulator(
        spec.make_layout(H),
        args.decoder,
        trellis=trellis,
        device=device,
        max_iters=args.max_iters or spec.decode_i_max,
        chain=args.chain,
        llr_source=llr_source,
        modulation=modulation,
        mod_order=mod_order,
        count_all_bits=spec.count_all_bits and args.chain == "allzero",
        cardinality_t_channel=cardinality_t_channel,
        batch_per_device=args.batch_per_device or spec.batch_hint,
        n_devices=args.n_devices,
        early_exit=not args.no_early_exit,
        encoder=encoder,
        seed=args.seed,
        steps_per_dispatch=args.steps_per_dispatch,
    )
    sched = SweepSchedule(
        start_db=args.start_db,
        normal_step_db=args.step_db,
        max_db=args.max_db if args.max_db is not None else spec.sweep_max_db,
        target_ber=args.target_ber,
        min_errors=args.min_errors or spec.min_errors,
        **({"max_blocks_per_point": args.max_blocks_per_point}
           if args.max_blocks_per_point else {}),
    )
    with device_trace(args.trace_dir):
        results = SweepController(
            sim, sched, results_path=args.results, write_results=is_primary,
            resume_state=resume_state,
        ).run()
    if is_primary:
        if args.export_npz:
            export_npz(args.export_npz, results)
        if args.export_mat:
            export_mat(args.export_mat, results, decoder_name=args.model)
        if args.export_plot:
            export_plot(args.export_plot, results, label=f"{args.model}/{args.decoder}")
    return [r.to_dict() for r in results]


def broadcast_resume_state(mesh, results_path: str) -> dict:
    """Process 0's results file (its completed points and the point in
    progress) on every rank, as length-prefixed uint8 (``{}`` when process 0
    has none)."""
    payload = b"{}"
    if mesh.rank == 0 and os.path.exists(results_path):
        with open(results_path, "rb") as f:
            payload = f.read()
    return json.loads(mesh.broadcast_bytes(payload).decode())


if __name__ == "__main__":
    main()
