"""The system under test: the port's Monte-Carlo engine, built as its
command-line sweep builds it, from the inputs the benchmark loads.

The benchmark hands the port the configuration's parity-check matrix and
decoder tables; the port lays the graph out (its model preset's node and
edge order), builds its encoder and decoder, and runs each dispatch through
``BERSimulator.run_point``.
"""

from __future__ import annotations

import scipy.sparse as sp
import torch

from informationbottleneckdecodingldpc_torch.construct import DecoderConfig
from informationbottleneckdecodingldpc_torch.decode import DeviceTrellis
from informationbottleneckdecodingldpc_torch.encode import LDPCEncoder
from informationbottleneckdecodingldpc_torch.models import get_model
from informationbottleneckdecodingldpc_torch.sim import BERSimulator
from informationbottleneckdecodingldpc_torch.sim.engine import PointCheckpoint


def simulator(cell: dict, H: sp.csr_matrix, tables_path: str, device: torch.device,
              seed: int) -> BERSimulator:
    """The engine of a cell (a workload with its ``config_spec``)."""
    config = cell["config_spec"]
    decoder, channel = config["decoder"], config["channel"]
    trellis, t_channel = None, channel.get("cardinality_t")
    if decoder["kind"] == "ib":
        tables = DecoderConfig.load(tables_path).tables
        trellis = DeviceTrellis.from_tables(tables, device, use_matching=decoder["message_alignment"])
        t_channel = tables.cardinality_t_channel
    return BERSimulator(
        get_model(config["program"]["model"]).make_layout(H),
        decoder["kind"],
        device=device,
        trellis=trellis,
        max_iters=decoder["i_max"],
        chain=cell["chain"],
        count_all_bits=config["code"]["counted_bits"] == "all",
        cardinality_t_channel=t_channel,
        ad_max_abs=channel["ad_max_abs"],
        cardinality_y_channel=channel["cardinality_y"],
        batch_per_device=cell["batch"],
        early_exit=decoder["early_exit"],
        encoder=LDPCEncoder(H) if cell["chain"] == "encoded" else None,
        seed=seed,
        steps_per_dispatch=cell["steps_per_dispatch"],
        backend=cell["backend"],
    )


def exit_tile(sim: BERSimulator) -> int:
    """The codewords that exit together in the engine's decoder."""
    return getattr(sim.fused_decoder, "batch_tile", None) or sim.batch_per_device


def checkpoint(ebn0_db: float, step_index: int) -> PointCheckpoint:
    """A point's state before its first dispatch, at ``step_index``."""
    return PointCheckpoint(ebn0_db=float(ebn0_db), step_index=step_index, errors=0,
                           frame_errors=0, blocks=0, iters_sum=0.0)
