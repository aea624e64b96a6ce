"""Decoder-config artifact cache (build once, reuse across runs)."""

from __future__ import annotations

import os

from ..construct import DecoderConfig, build_decoder_config
from .zoo import ModelSpec, get_model

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "artifacts",
)


def config_path(spec: ModelSpec, ebn0: float, i_max: int, t: int, directory: str) -> str:
    return os.path.join(
        directory, f"decoder_{spec.name}_ebn0_{ebn0:g}_T{t}_imax{i_max}.npz"
    )


def get_or_build_config(
    model: str | ModelSpec,
    ebn0: float | None = None,
    i_max: int | None = None,
    cardinality_t: int | None = None,
    directory: str = DEFAULT_DIR,
    verbose: bool = False,
) -> DecoderConfig:
    spec = get_model(model) if isinstance(model, str) else model
    ebn0 = spec.design_ebn0_db if ebn0 is None else ebn0
    i_max = spec.de_i_max if i_max is None else i_max
    t = spec.cardinality_t_decoder if cardinality_t is None else cardinality_t
    os.makedirs(directory, exist_ok=True)
    path = config_path(spec, ebn0, i_max, t, directory)
    if os.path.exists(path):
        return DecoderConfig.load(path)
    kwargs = dict(
        design_ebn0_db=ebn0,
        cardinality_t_channel=t if cardinality_t is not None else spec.cardinality_t_channel,
        cardinality_t_decoder=t,
        i_max=i_max,
        verbose=verbose,
    )
    if spec.irregular:
        kwargs["H"] = spec.make_h()
    else:
        kwargs["d_v"], kwargs["d_c"] = spec.d_v, spec.d_c
    cfg = build_decoder_config(**kwargs)
    cfg.save(path)
    return cfg
