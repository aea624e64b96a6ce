"""Monte-Carlo BER engine for the all-zeros IB chain.

Port of ``sim/engine.py`` for ``decoder="ib"``, ``chain="allzero"``,
``modulation="bpsk"`` on one device: each step draws a uniform plane
[n_vars, batch], samples channel clusters by inversion, decodes (the fused
kernel on a CUDA device, its plain twin on the CPU) and counts bit and frame
errors over the counted prefix. The host loop accumulates the counters until
``min_errors`` bit errors or ``max_blocks`` blocks.

Randomness: step ``s`` of the point at ``ebn0_db`` draws from a
``torch.Generator`` on the device seeded from ``(seed, round(ebn0_db*1000),
s)``, so a point can resume at step granularity. Unlike the JAX engine,
which keys every codeword, the counters depend on the batch size.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..channel.awgn import sigma2_from_ebn0_db
from ..channel.quantizer import (
    DeviceQuantizerTables,
    build_quantizer_tables,
    device_tables,
    sample_clusters_from_uniform,
)
from ..decode.graph_arrays import DecodeLayout
from ..decode.ib_lut import DeviceTrellis
from ..kernels.ib_lut_fused import FusedIBDecoder


@dataclasses.dataclass
class PointResult:
    """Result of one Eb/N0 point (the JAX engine's keys)."""

    ebn0_db: float
    ber: float
    fer: float
    errors: int
    frame_errors: int
    blocks: int
    bits_counted: int
    elapsed_s: float
    coded_bits_per_s: float
    info_bits_per_s: float
    mean_iterations: float

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def step_seed(seed: int, ebn0_db: float, step_index: int) -> int:
    """63-bit generator seed of one Monte-Carlo step."""
    words = [seed, int(round(ebn0_db * 1000)) % 2**32, step_index]
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def resolve_device(device: torch.device | str) -> torch.device:
    """The device, raising if it is a CUDA device this host does not have."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA device was requested but none is available")
    return device


class BERSimulator:
    """BER simulator for one (code, IB decoder) pair on one device.

    It decodes with :class:`FusedIBDecoder`: the K1 kernel on CUDA, its
    plain twin on CPU, early exit per tile of ``batch_tile`` codewords
    (``batch_tile=batch_per_device`` gives whole-batch lockstep).
    """

    def __init__(
        self,
        layout: DecodeLayout,
        decoder: str,
        *,
        trellis: DeviceTrellis,
        device: torch.device | str,
        max_iters: int | None = None,
        chain: str = "allzero",
        count_all_bits: bool = False,
        cardinality_t_channel: int = 16,
        ad_max_abs: float = 3.0,
        cardinality_y_channel: int = 2000,
        batch_per_device: int = 128,
        n_devices: int = 1,
        early_exit: bool = True,
        seed: int = 0,
        batch_tile: int | None = None,
        steps_per_dispatch: int = 1,
        modulation: str = "bpsk",
    ):
        if decoder != "ib":
            raise NotImplementedError(
                f"decoder {decoder!r} is not ported yet (ROADMAP item 7)"
            )
        if chain != "allzero":
            raise NotImplementedError(
                f"chain {chain!r} is not ported yet (ROADMAP item 6)"
            )
        if modulation != "bpsk":
            raise NotImplementedError(
                f"modulation {modulation!r} is not ported yet (ROADMAP item 9)"
            )
        if n_devices != 1:
            raise NotImplementedError(
                "more than one device is not ported yet (ROADMAP item 10)"
            )
        self.device = resolve_device(device)
        if trellis.device != self.device:
            raise ValueError(
                f"trellis lives on {trellis.device}, simulator on {self.device}"
            )
        self.layout = layout
        self.trellis = trellis
        self.max_iters = int(max_iters or trellis.i_max)
        self.count_all_bits = bool(count_all_bits)
        self.cardinality_t_channel = int(cardinality_t_channel)
        self.ad_max_abs = float(ad_max_abs)
        self.cardinality_y_channel = int(cardinality_y_channel)
        self.batch_per_device = int(batch_per_device)
        self.batch_total = self.batch_per_device
        self.early_exit = bool(early_exit)
        self.seed = int(seed)
        self.steps_per_dispatch = max(1, int(steps_per_dispatch))
        self.prefix_len = layout.n_vars if self.count_all_bits else layout.data_len
        self.fused_decoder = FusedIBDecoder(
            layout,
            trellis.host,
            max_iters=self.max_iters,
            early_exit=self.early_exit,
            use_matching=trellis.matching_cn is not None,
            batch_tile=batch_tile,
        )
        self._quant_cache: dict[float, DeviceQuantizerTables] = {}
        self._generator = torch.Generator(device=self.device)

    # ------------------------------------------------------------------
    def _count_errors(
        self, outputs: torch.Tensor, reference_bits: torch.Tensor
    ) -> torch.Tensor:
        """Per-codeword bit errors over the counted prefix; the IB decision
        is bit = (cluster < T/2)."""
        prefix = outputs[: self.prefix_len]
        hard = prefix < (self.trellis.t_decoder // 2)
        wrong = hard != reference_bits[: self.prefix_len].bool()
        return wrong.sum(dim=0, dtype=torch.int32)

    def step_from_uniform(self, u: torch.Tensor, qt: DeviceQuantizerTables):
        """One Monte-Carlo block from a float32 uniform plane [n_vars,
        batch]: (bit errors, frame errors, iterations) as device scalars."""
        bits = torch.zeros(u.shape, dtype=torch.int32, device=u.device)
        clusters = sample_clusters_from_uniform(qt.cdf, u, bits)
        res = self.fused_decoder(clusters)
        errors = self._count_errors(res.outputs, bits)
        return (
            errors.sum(dtype=torch.int32),
            (errors > 0).sum(dtype=torch.int32),
            res.iterations.to(torch.float32),
        )

    def _step(self, ebn0_db: float, step_index: int, qt: DeviceQuantizerTables):
        """``steps_per_dispatch`` blocks from ``step_index`` on, without a
        host sync: summed errors and frame errors, mean iterations."""
        e = f = it = None
        for j in range(self.steps_per_dispatch):
            self._generator.manual_seed(
                step_seed(self.seed, ebn0_db, step_index + j)
            )
            u = torch.rand(
                (self.layout.n_vars, self.batch_total),
                generator=self._generator,
                device=self.device,
                dtype=torch.float32,
            )
            de, df, dit = self.step_from_uniform(u, qt)
            e, f, it = (de, df, dit) if e is None else (e + de, f + df, it + dit)
        return e, f, it / self.steps_per_dispatch

    def quantizer_for(self, ebn0_db: float) -> DeviceQuantizerTables:
        key = round(float(ebn0_db), 6)
        if key not in self._quant_cache:
            sigma2 = float(sigma2_from_ebn0_db(ebn0_db, self.layout.code_rate))
            tables = build_quantizer_tables(
                sigma2,
                self.ad_max_abs,
                self.cardinality_t_channel,
                self.cardinality_y_channel,
            )
            self._quant_cache[key] = device_tables(tables, self.device)
        return self._quant_cache[key]

    def run_point(
        self,
        ebn0_db: float,
        min_errors: int = 7000,
        max_blocks: int = 10_000_000,
    ) -> PointResult:
        """Accumulate blocks until ``min_errors`` bit errors or at least
        ``max_blocks`` blocks (whole dispatches)."""
        qt = self.quantizer_for(ebn0_db)
        errors = frame_errors = blocks = step_index = 0
        iters_sum = 0.0
        blocks_per_dispatch = self.batch_total * self.steps_per_dispatch
        start = time.time()
        while errors < min_errors and blocks < max_blocks:
            e, f, it = self._step(ebn0_db, step_index, qt)
            errors += int(e)
            frame_errors += int(f)
            iters_sum += float(it) * blocks_per_dispatch
            blocks += blocks_per_dispatch
            step_index += self.steps_per_dispatch
        elapsed = time.time() - start

        bits_counted = blocks * self.prefix_len
        coded_bits = blocks * self.layout.n_vars
        info_bits = blocks * self.layout.data_len
        return PointResult(
            ebn0_db=float(ebn0_db),
            ber=errors / max(bits_counted, 1),
            fer=frame_errors / max(blocks, 1),
            errors=errors,
            frame_errors=frame_errors,
            blocks=blocks,
            bits_counted=bits_counted,
            elapsed_s=elapsed,
            coded_bits_per_s=coded_bits / max(elapsed, 1e-9),
            info_bits_per_s=info_bits / max(elapsed, 1e-9),
            mean_iterations=iters_sum / max(blocks, 1),
        )
