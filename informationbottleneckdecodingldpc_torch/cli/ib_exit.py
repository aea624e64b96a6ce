"""Count, per decoder iteration, the codewords whose IB message syndrome is zero.

The IB decoder exits early when the hard decisions of the variable-to-check
messages (cluster < |T|/2 is bit 1) satisfy every check, the test of the
JAX package's ``decode/ib_lut.py`` and of the reference kernels. This runs
the port's plain whole-batch decoder (``decode/ib_lut.py``) on the all-zeros
chain with early exit off, once for each body count b = 1 .. i_max - 1, and
counts after b bodies the codewords whose syndrome is zero, and how many
tiles of 16 (K1's tile), 128 (the JAX fused kernel's tile) and the whole
batch are zero in every codeword: a tile exits after the first body at
which it is. It prints one JSON object per Eb/N0 and, with ``--out``, writes
them all. It runs on the card unless ``--device cpu`` is given (WLAN at
batch 128: about a minute a point on a CPU).

Usage:
  python -m informationbottleneckdecodingldpc_torch.cli.ib_exit \\
      --ebn0 2.0,2.2,2.4 --batch 128 --out ib_exit.json
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..channel import build_quantizer_tables, device_tables, sample_clusters_from_uniform
from ..channel.awgn import sigma2_from_ebn0_db
from ..construct import DecoderConfig
from ..decode import DeviceTrellis, ib_lut_decode
from ..models import get_model
from ..sim.engine import resolve_device

TILES = (16, 128)


def exit_counts(layout, trellis: DeviceTrellis, clusters: torch.Tensor) -> dict:
    """Per body (1 .. i_max - 1) of one decode without early exit: the
    codewords with a zero message syndrome, and the tiles of each size in
    :data:`TILES` (and the whole batch) zero in every codeword; and per tile
    size, the mean body count an early-exit decoder in such tiles reports
    (each tile's first all-zero body, or every body if it has none)."""
    batch = clusters.shape[1]
    zero = torch.stack([
        ib_lut_decode(layout, trellis, clusters, max_iters=b + 1, early_exit=False).unsatisfied == 0
        for b in range(1, trellis.i_max)
    ]).cpu()  # [bodies, batch]
    bodies = len(zero)
    out = {"codewords": zero.sum(1).tolist(), "mean_exit_body": {}}
    for tile in (1, *TILES, batch):
        whole = batch // tile * tile
        if not whole:
            continue
        tiles = zero[:, :whole].view(bodies, -1, tile).all(2)  # [bodies, tiles]
        first = torch.where(tiles.any(0), tiles.int().argmax(0) + 1, bodies)
        out["mean_exit_body"][str(tile)] = float(first.float().mean())
        if tile in TILES:
            out[f"tiles_of_{tile}"] = tiles.sum(1).tolist()
    out["whole_batch"] = zero.all(1).int().tolist()
    return out


def first_exit(zero_counts: list[int], total: int) -> int | None:
    """The first body after which all ``total`` (at least one) are zero, or
    None."""
    return next((b + 1 for b, n in enumerate(zero_counts) if n == total > 0), None)


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default="results/configs/wlan_T16_0.8.npz")
    p.add_argument("--model", default="wlan-1296")
    p.add_argument("--ebn0", default="2.0,2.2,2.4", help="comma-separated Eb/N0 (dB)")
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--out", default=None, help="JSON file of every point")
    args = p.parse_args(argv)
    args.device = resolve_device(args.device)

    layout = get_model(args.model).make_layout()
    tables = DecoderConfig.load(args.config).tables
    trellis = DeviceTrellis.from_tables(tables, args.device)
    points = []
    for k, ebn0 in enumerate(float(x) for x in args.ebn0.split(",")):
        sigma2 = sigma2_from_ebn0_db(ebn0, layout.code_rate)
        qt = device_tables(build_quantizer_tables(
            sigma2, 3.0, tables.cardinality_t_channel, 2000), args.device)
        u = np.random.default_rng(args.seed + k).random((layout.n_vars, args.batch),
                                                        dtype=np.float32)
        u = torch.as_tensor(u, device=args.device)
        clusters = sample_clusters_from_uniform(qt.cdf, u, torch.zeros_like(u, dtype=torch.int32))
        counts = exit_counts(layout, trellis, clusters)
        point = {"ebn0_db": ebn0, "batch": args.batch, "seed": args.seed + k,
                 "bodies": len(counts["codewords"]), **counts}
        point["first_exit"] = {
            "codeword_all": first_exit(counts["codewords"], args.batch),
            **{f"tile_of_{t}_all": first_exit(counts[f"tiles_of_{t}"], args.batch // t)
               for t in TILES},
        }
        print(json.dumps(point), flush=True)
        points.append(point)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"config": args.config, "points": points}, f, indent=1)
    return points


if __name__ == "__main__":
    main()
