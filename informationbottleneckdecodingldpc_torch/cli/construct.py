"""Build a discrete IB decoder config for a design Eb/N0.

Equivalent of the reference's ``decoder_config_generation.py`` scripts
(Regular_LDPC_Decoding/BPSK & Irregular_LDPC_Decoding/{WLAN,DVB-S2}), with a
real CLI instead of constants at the top of a script, and a pickle-free .npz
artifact. The port's copy of the JAX package's CLI: host numpy only, the
same flags and the same arrays.

Usage:
  python -m informationbottleneckdecodingldpc_torch.cli.construct \
      --model wlan-1296 --ebn0 0.8 --output wlan_0.8.npz
"""

from __future__ import annotations

import argparse

from ..construct import build_decoder_config
from ..models import get_model


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", required=True, help="model zoo name")
    p.add_argument("--ebn0", type=float, default=None, help="design Eb/N0 in dB")
    p.add_argument("--i-max", type=int, default=None)
    p.add_argument("--cardinality-t", type=int, default=None)
    p.add_argument("--no-match", action="store_true", help="disable message alignment")
    p.add_argument("--ib-backend", choices=["dp", "sib"], default="dp",
                   help="DE compression: 'dp' exact DP (default) or 'sib' "
                        "randomized sequential IB with --nror restarts (the "
                        "reference's lin_sym_sIB construction stack)")
    p.add_argument("--nror", type=int, default=10,
                   help="sIB restarts per compression step (reference: 10)")
    p.add_argument("--ib-seed", type=int, default=0)
    p.add_argument("--output", required=True)
    p.add_argument("--export-exit-chart", default=None,
                   help="write the DE MI-trajectory (EXIT-style) plot "
                        "(png/pdf), like the reference's "
                        "decoder_config_generation.py:42-61")
    p.add_argument("--verbose", action="store_true")
    args = p.parse_args(argv)

    spec = get_model(args.model)
    ebn0 = args.ebn0 if args.ebn0 is not None else spec.design_ebn0_db
    i_max = args.i_max or spec.de_i_max
    t = args.cardinality_t or spec.cardinality_t_decoder
    t_ch = args.cardinality_t or spec.cardinality_t_channel

    kwargs = dict(
        design_ebn0_db=ebn0,
        cardinality_t_channel=t_ch,
        cardinality_t_decoder=t,
        i_max=i_max,
        match=not args.no_match,
        verbose=args.verbose,
        ib_backend=args.ib_backend,
        ib_nror=args.nror,
        ib_seed=args.ib_seed,
    )
    if spec.irregular:
        kwargs["H"] = spec.make_h()
    else:
        kwargs["d_v"], kwargs["d_c"] = spec.d_v, spec.d_c

    cfg = build_decoder_config(**kwargs)
    cfg.save(args.output)
    if args.export_exit_chart:
        cfg.export_exit_chart(args.export_exit_chart, label=args.model)
    print(
        f"saved {args.output}: design {ebn0} dB, |T|={t}, i_max={i_max}, "
        f"final decision MI={cfg.mi_trajectory[-1]:.6f}"
    )


if __name__ == "__main__":
    main()
