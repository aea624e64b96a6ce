"""Run a BER sweep of the IB, min-sum or BP decoder on a BPSK chain.

Reduced port of ``cli/simulate.py``: one ``run_point`` per Eb/N0 from
``--start-db`` to ``--max-db`` in steps of ``--step-db``; after each point
the results file is rewritten as ``{"points": [...]}`` with the JAX engine's
point keys. Sweep resume, exports and M-ary modulations are not ported yet.
The default device is ``cuda``; without a card the run raises.

Usage:
  python -m informationbottleneckdecodingldpc_torch.cli.simulate \\
      --model wlan-1296 --config results/configs/wlan_T16_0.8.npz \\
      --start-db 0.8 --max-db 1.6 --step-db 0.4 --results wlan_ib.json
  python -m informationbottleneckdecodingldpc_torch.cli.simulate \\
      --model wlan-1296 --decoder minsum --chain encoded \\
      --start-db 1.2 --max-db 1.6 --step-db 0.4 --results wlan_minsum.json
  python -m informationbottleneckdecodingldpc_torch.cli.simulate \\
      --model dvbs2-64800 --config results/configs/dvbs2_T16_0.6.npz \\
      --chain encoded --start-db 0.9 --max-db 1.1 --batch-per-device 1024 \\
      --results dvbs2_ib.json

DVB-S2 N=64800 does not fit the shared-memory kernels, so the engine's
``backend='auto'`` decodes it with the device-memory kernels K3 (IB) and K4
(min-sum, BP).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..construct import DecoderConfig
from ..decode import DeviceTrellis
from ..encode import LDPCEncoder
from ..models import get_model
from ..sim import BERSimulator
from ..sim.engine import resolve_device


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    p.add_argument("--model", required=True)
    p.add_argument("--decoder", choices=["ib", "minsum", "bp"], default="ib")
    p.add_argument("--config", default=None, help="decoder config .npz (ib)")
    p.add_argument("--chain", choices=["allzero", "encoded"], default="allzero")
    p.add_argument("--llr-source", choices=["quantized", "true"], default="quantized")
    p.add_argument("--start-db", type=float, default=0.0)
    p.add_argument("--max-db", type=float, default=None)
    p.add_argument("--step-db", type=float, default=0.1)
    p.add_argument("--min-errors", type=int, default=None)
    p.add_argument("--max-blocks-per-point", type=int, default=10_000_000)
    p.add_argument("--max-iters", type=int, default=None)
    p.add_argument("--t-channel", type=int, default=None,
                   help="channel-quantizer cardinality |T_ch| for the float "
                        "decoders (default: the model's)")
    p.add_argument("--batch-per-device", type=int, default=None)
    p.add_argument("--steps-per-dispatch", type=int, default=1)
    p.add_argument("--no-early-exit", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--results", required=True, help="JSON results file")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    spec = get_model(args.model)
    H = spec.make_h()
    trellis = None
    cardinality_t_channel = spec.cardinality_t_channel
    if args.decoder == "ib":
        if not args.config:
            p.error("--config is required for the ib decoder")
        if args.t_channel is not None:
            p.error("--t-channel applies to the float decoders only (the ib "
                    "decoder's |T_ch| comes from its config)")
        cfg = DecoderConfig.load(args.config)
        trellis = DeviceTrellis.from_tables(cfg.tables, device)
        cardinality_t_channel = cfg.tables.cardinality_t_channel
    elif args.t_channel is not None:
        cardinality_t_channel = args.t_channel
    encoder = LDPCEncoder(H) if args.chain == "encoded" else None
    sim = BERSimulator(
        spec.make_layout(H),
        args.decoder,
        trellis=trellis,
        device=device,
        max_iters=args.max_iters or spec.decode_i_max,
        chain=args.chain,
        llr_source=args.llr_source,
        count_all_bits=spec.count_all_bits and args.chain == "allzero",
        cardinality_t_channel=cardinality_t_channel,
        batch_per_device=args.batch_per_device or spec.batch_hint,
        early_exit=not args.no_early_exit,
        encoder=encoder,
        seed=args.seed,
        steps_per_dispatch=args.steps_per_dispatch,
    )
    max_db = args.max_db if args.max_db is not None else spec.sweep_max_db
    n_points = int(np.floor((max_db - args.start_db) / args.step_db + 1e-9)) + 1
    points = []
    for k in range(max(n_points, 0)):
        ebn0 = round(args.start_db + k * args.step_db, 6)
        r = sim.run_point(
            ebn0,
            min_errors=args.min_errors or spec.min_errors,
            max_blocks=args.max_blocks_per_point,
        )
        points.append(r.to_dict())
        print(
            f"EbN0={ebn0:.2f} dB BER={r.ber:.3e} FER={r.fer:.3e} "
            f"blocks={r.blocks} iters={r.mean_iterations:.2f}",
            flush=True,
        )
        tmp = args.results + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"points": points}, f, indent=2)
        os.replace(tmp, args.results)
    return points


if __name__ == "__main__":
    main()
