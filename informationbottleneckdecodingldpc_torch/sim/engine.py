"""Monte-Carlo BER engine: the BPSK and M-ary chains, resumable, on one
device or data-parallel over ``torch.distributed``.

Port of ``sim/engine.py`` for ``decoder`` in ``ib | minsum | bp``, ``chain``
in ``allzero | encoded``, ``llr_source`` in ``quantized | true``,
``modulation`` in ``bpsk | qam | mpsk``. Each step draws its
random planes, builds the channel input, decodes (the kernels on a CUDA
device and their plain twins on the CPU, or with ``backend='xla'`` the plain
whole-batch decoders on either) and counts bit and frame errors over the
counted prefix. The host loop accumulates the counters until ``min_errors``
bit errors or ``max_blocks`` blocks; its state (:class:`PointCheckpoint`)
resumes a point mid-way.

Chains:

- ``allzero``: the all-zeros codeword. Quantized input is sampled by
  inversion from a uniform plane (clusters for IB, their LLRs for the float
  decoders); true LLRs are 2y/sigma^2 of y = 1 + sigma n.
- ``encoded``: random info bits -> GF(2) encode on the device -> BPSK ->
  AWGN -> threshold quantizer (clusters or LLRs) or 2y/sigma^2; errors are
  counted against the transmitted bits.
- M-ary (``modulation='qam'|'mpsk'``, the encoded chain into a float decoder
  on true LLRs): info bits -> encode -> QAM or M-PSK map
  (``channel/modulation.py``) -> complex AWGN with n0/2 per component ->
  the exact soft demapper (``channel/demap.py``).

Randomness is keyed per codeword, as in the JAX engine (``sim/rng.py``):
column i of every random plane of step ``s`` at ``ebn0_db`` is a pure
function of ``(seed, round(ebn0_db*1000), s, i)``, Philox4x32-10 under the
step's key (:func:`step_seed`) counted by the global codeword index i and a
stream per plane (info bits, noise, inversion uniforms). So codeword i of a
step is the same at any batch size, a batch split into shards
(``_draw_step``'s ``offset``) counts what the whole batch counts, and a
point resumes at step granularity. The BPSK encoded chain draws info bits
and a normal noise plane; the all-zeros chain one uniform (quantized) or
normal (true LLRs) plane. A BPSK step's channel input is one
``rng.channel_input`` call (:attr:`BERSimulator.channel_input_kind`): on a
CUDA device one launch of the Philox kernel (``kernels/philox_planes.py``),
which draws and turns the draws into the decoder's input in registers; on
the CPU its plain version, the plane followed by the quantizer and AWGN
operators. The encoded chain's info bits are a plane of the same kernel,
encoded on the device. An M-ary step draws its info bits and a normal plane
of 2 n_vars / k rows (row 2s + c is component c of symbol s), each a plane
of that kernel; the map and the demap run as torch operators.

While ``torch.profiler`` records, the engine marks its layers with ranges
(``utils/profiling.py`` ``span``; one check each when nothing records):
``sim.run_point`` holds a ``sim.dispatch`` per dispatch, which holds the
dispatch's ``sim.step`` ranges and its ``sim.readback`` (the counters'
wait and copies to the host); a step holds ``sim.seed`` (its key),
``sim.channel_input`` (the draws and the decoder's input, with
``sim.encode`` inside it on the encoded chains), ``sim.decode`` and
``sim.count``; a process group's all-reduce is ``sim.all_reduce``.

Data parallelism (the JAX engine's ``shard_map`` path) is one process per
card (``parallel/mesh.py``): in a process group of ``world`` ranks, rank r
draws and decodes codewords [r B, (r + 1) B) of each step's global batch of
B world (``batch_per_device`` B), so a step counts what one process at the
global batch counts. Each dispatch's (errors, frame errors, mean iterations)
are all-reduced once, the mean iterations being the mean of the ranks'
means as in JAX (``psum(iters) / n_devices``); every rank therefore leaves
``run_point``'s loop after the same dispatch. With ``backend='xla'`` the
whole-batch decoders' early exit is all-reduced after every body, so all
ranks run the same bodies; the kernels exit per tile of their rank's shard.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable

import numpy as np
import torch

from ..channel.awgn import sigma2_from_ebn0_db
from ..channel.demap import demap_llrs
from ..channel.modulation import Constellation, gray_encoding_table
from ..channel.quantizer import DeviceQuantizerTables, build_quantizer_tables, device_tables
from ..construct.trellis import TrellisTables
from ..decode.bp import belief_propagation_decode
from ..decode.common import DecodeResult
from ..decode.graph_arrays import DecodeLayout
from ..decode.ib_lut import DeviceTrellis, ib_lut_decode
from ..decode.min_sum import min_sum_decode
from ..encode.encoder import device_encoder
from ..kernels import float_fused, ib_lut_fused
from ..kernels.float_hbm import HBMFloatDecoder
from ..kernels.ib_lut_hbm import HBMFusedIBDecoder
from ..parallel.mesh import make_mesh, psum_convergence_reduce
from ..utils.profiling import span
from . import rng

# The decoder classes of each backend, IB then float.
BACKENDS = {
    "fused": (ib_lut_fused.FusedIBDecoder, float_fused.FusedFloatDecoder),
    "hbm": (HBMFusedIBDecoder, HBMFloatDecoder),
}


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


@dataclasses.dataclass
class PointCheckpoint:
    """Mid-point resumable state: the Eb/N0, the next step index (the draws
    are keyed by it) and the counters so far."""

    ebn0_db: float
    step_index: int
    errors: int
    frame_errors: int
    blocks: int
    iters_sum: float


def step_seed(seed: int, ebn0_db: float, step_index: int) -> int:
    """63-bit key of one Monte-Carlo step (``sim/rng.py`` splits it into
    Philox's two key words)."""
    words = [seed, int(round(ebn0_db * 1000)) % 2**32, step_index]
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def resolve_device(device: torch.device | str) -> torch.device:
    """The device, raising if it is a CUDA device this host does not have."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA device was requested but none is available")
    return device


def fused_fits(layout: DecodeLayout, tables: TrellisTables | None) -> bool:
    """Whether one codeword of ``layout`` fits the shared memory of one CTA
    of K1 (IB ``tables``) or K2 (``tables`` None)."""
    if tables is not None:
        need = ib_lut_fused.shared_bytes(
            layout, 1, tables.cardinality_t_channel, tables.cardinality_t_decoder
        )
    else:
        need = float_fused.shared_bytes(layout, 1)
    return need <= ib_lut_fused.MAX_SHARED_BYTES


class WholeBatchDecoder:
    """``backend='xla'``: the plain whole-batch decoder (``ib_lut_decode``,
    ``min_sum_decode`` or ``belief_propagation_decode``) on the simulator's
    device, the counterpart of the JAX engine's XLA path. The whole batch
    runs in lockstep and exits early together, when no codeword has an
    unsatisfied check (of any rank, with the data-parallel engine's
    ``convergence_reduce``). ``calls`` counts decodes (it launches no kernel
    of its own)."""

    def __init__(
        self,
        layout: DecodeLayout,
        decoder: str,
        max_iters: int,
        early_exit: bool,
        trellis: DeviceTrellis | None = None,
        convergence_reduce=None,
    ):
        self.layout = layout
        self.decoder = decoder
        self.max_iters = max_iters
        self.early_exit = early_exit
        self.trellis = trellis
        self.convergence_reduce = convergence_reduce
        self.calls = 0

    def __call__(self, channel_input: torch.Tensor) -> DecodeResult:
        self.calls += 1
        if self.decoder == "ib":
            return ib_lut_decode(
                self.layout, self.trellis, channel_input,
                max_iters=self.max_iters, early_exit=self.early_exit,
                convergence_reduce=self.convergence_reduce,
            )
        fn = min_sum_decode if self.decoder == "minsum" else belief_propagation_decode
        return fn(self.layout, channel_input, self.max_iters, early_exit=self.early_exit,
                  convergence_reduce=self.convergence_reduce)


class BERSimulator:
    """BER simulator for one (code, decoder) pair on one device, or on one
    rank of a data-parallel process group.

    ``decoder`` is 'ib' (needs ``trellis``) or 'minsum' / 'bp' (need
    ``max_iters``). ``backend`` picks the decoder: 'fused' the shared-memory
    kernels (K1 :class:`FusedIBDecoder`, K2 :class:`FusedFloatDecoder`;
    raises if one codeword does not fit a CTA), 'hbm' the device-memory
    kernels (K3 :class:`HBMFusedIBDecoder`, K4 :class:`HBMFloatDecoder`),
    'auto' 'fused' when the layout fits and 'hbm' otherwise (DVB-S2
    N=64800). Each kernel backend is the CUDA kernel on a CUDA device and its
    plain twin on the CPU, and exits early per tile of ``batch_tile``
    codewords (default: the kernel's), not over the whole batch, so the mean
    iteration count depends on the tile while the BER does not;
    ``batch_tile=batch_per_device`` gives whole-batch lockstep. On a card,
    'hbm' takes tiles of up to 1024 codewords that its vector width divides
    (8 for IB, 4 for min-sum and BP) and refuses others when the simulator
    is built.

    'xla' is the whole-batch path the JAX package also offers, chosen only
    by name ('auto' never picks it) and not a fallback: the plain decoders
    (:class:`WholeBatchDecoder`) on the simulator's device, the whole batch
    in lockstep with one early exit, as the JAX engine's XLA decoders run;
    it takes no ``batch_tile``.

    The encoded chain needs the host ``encoder`` (``encode.LDPCEncoder``),
    whose matrices go to the device once.

    ``modulation`` 'qam' or 'mpsk' (``mod_order`` sqrt(M) for QAM, M for
    M-PSK, Gray-coded) runs the encoded chain into a float decoder on the
    exact demapper's LLRs; the JAX engine's conditions hold (a float decoder,
    ``llr_source='true'``, the encoded chain, ``n_vars`` a multiple of the
    bits per symbol) and raise ``ValueError`` otherwise.

    ``n_devices`` is the world size of the initialised process group
    (``parallel.initialize_multihost``), 1 without one; None takes it and any
    other value raises ``ValueError``. Each rank decodes ``batch_per_device``
    codewords of a step's ``batch_total`` from ``offset`` on; the counters
    every dispatch returns are the global batch's on every rank.
    """

    def __init__(
        self,
        layout: DecodeLayout,
        decoder: str,
        *,
        device: torch.device | str,
        trellis: DeviceTrellis | None = None,
        max_iters: int | None = None,
        chain: str = "allzero",
        llr_source: str = "quantized",
        count_all_bits: bool = False,
        cardinality_t_channel: int = 16,
        ad_max_abs: float = 3.0,
        cardinality_y_channel: int = 2000,
        batch_per_device: int = 128,
        n_devices: int | None = 1,
        early_exit: bool = True,
        encoder=None,
        seed: int = 0,
        batch_tile: int | None = None,
        steps_per_dispatch: int = 1,
        modulation: str = "bpsk",
        mod_order: int = 2,
        backend: str = "auto",
    ):
        if decoder not in ("ib", "minsum", "bp"):
            raise ValueError(f"unknown decoder {decoder!r}")
        if chain not in ("allzero", "encoded"):
            raise ValueError(f"unknown chain {chain!r}")
        if llr_source not in ("quantized", "true"):
            raise ValueError(f"unknown llr_source {llr_source!r}")
        if backend not in ("auto", "fused", "hbm", "xla"):
            raise ValueError(f"unknown backend {backend!r}")
        if modulation not in ("bpsk", "qam", "mpsk"):
            raise ValueError(f"unknown modulation {modulation!r}")
        self.modulation = modulation
        self.mod_order = int(mod_order)
        if modulation != "bpsk":
            # The IB construction path is BPSK-only: M-ary chains decode the
            # exact demapper's LLRs with a float decoder.
            if decoder == "ib" or llr_source != "true":
                raise ValueError("qam/mpsk require a float decoder with llr_source='true'")
            if chain != "encoded":
                raise ValueError(
                    "qam/mpsk require the encoded chain (the all-zeros shortcut needs the "
                    "BPSK/quantizer symmetry)"
                )
            bits = int(np.log2(self.mod_order))
            k = 2 * bits if modulation == "qam" else bits
            if layout.n_vars % k:
                raise ValueError(
                    f"codeword length {layout.n_vars} not divisible by {k} bits/symbol"
                )
            self._bits_per_symbol = k
            self._encoding_table = gray_encoding_table(k // 2 if modulation == "qam" else k)
        self.device = resolve_device(device)
        self.mesh = make_mesh(n_devices, self.device)
        self.n_devices = self.mesh.world
        if modulation != "bpsk":
            self._constellation = Constellation.build(
                modulation, self.mod_order, self._encoding_table, self.device)
        self.layout = layout
        self.decoder = decoder
        self.chain = chain
        self.llr_source = llr_source
        self.trellis = trellis
        if decoder == "ib":
            if trellis is None:
                raise ValueError("the ib decoder requires trellis tables")
            if trellis.device != self.device:
                raise ValueError(
                    f"trellis lives on {trellis.device}, simulator on {self.device}"
                )
            self.max_iters = int(max_iters or trellis.i_max)
        elif max_iters is None:
            raise ValueError("float decoders require max_iters")
        else:
            self.max_iters = int(max_iters)
        self.count_all_bits = bool(count_all_bits)
        self.cardinality_t_channel = int(cardinality_t_channel)
        self.ad_max_abs = float(ad_max_abs)
        self.cardinality_y_channel = int(cardinality_y_channel)
        self.batch_per_device = int(batch_per_device)
        self.batch_total = self.batch_per_device * self.n_devices
        self.offset = self.mesh.rank * self.batch_per_device  # this rank's first codeword
        self.early_exit = bool(early_exit)
        self.seed = int(seed)
        self.steps_per_dispatch = max(1, int(steps_per_dispatch))
        self.prefix_len = layout.n_vars if self.count_all_bits else layout.data_len
        self._encode = None
        if chain == "encoded":
            if encoder is None:
                raise ValueError("the encoded chain requires an LDPCEncoder")
            self._info_len = encoder.k
            self._encode = device_encoder(encoder, self.device)
        self._quant_cache: dict[float, DeviceQuantizerTables] = {}
        self._key = rng.key_words(step_seed(self.seed, 0.0, 0))  # set per step by _step
        if backend == "xla":
            if batch_tile is not None:
                raise ValueError("backend='xla' decodes the whole batch; it takes no batch_tile")
            self.backend = backend
            reduce = psum_convergence_reduce(self.mesh) if self.mesh.group is not None else None
            self.fused_decoder = WholeBatchDecoder(
                layout, decoder, self.max_iters, self.early_exit, trellis, reduce
            )
            return
        fits = fused_fits(layout, trellis.host if decoder == "ib" else None)
        if backend == "fused" and not fits:
            raise ValueError(
                "backend='fused': one codeword of this layout does not fit the "
                "shared memory of one CTA; use backend='hbm'"
            )
        if backend == "auto":
            backend = "fused" if fits else "hbm"
        self.backend = backend
        ib_class, float_class = BACKENDS[backend]
        if decoder == "ib":
            self.fused_decoder = ib_class(
                layout,
                trellis.host,
                max_iters=self.max_iters,
                early_exit=self.early_exit,
                use_matching=trellis.matching_cn is not None,
                batch_tile=batch_tile,
            )
        else:
            self.fused_decoder = float_class(
                layout,
                rule=decoder,
                max_iters=self.max_iters,
                early_exit=self.early_exit,
                batch_tile=batch_tile,
            )
        if backend == "hbm" and self.device.type == "cuda":
            self.fused_decoder.check_tile()

    # ------------------------------------------------------------------
    def _count_errors(
        self, outputs: torch.Tensor, reference_bits: torch.Tensor | None = None
    ) -> torch.Tensor:
        """Per-codeword bit errors over the counted prefix; the decision is
        bit = (cluster < T/2) for IB and bit = (llr < 0) for the float
        decoders. With no ``reference_bits`` (the all-zeros codeword) every
        decided 1 is an error."""
        prefix = outputs[: self.prefix_len]
        if self.decoder == "ib":
            hard = prefix < (self.trellis.t_decoder // 2)
        else:
            hard = prefix < 0
        if reference_bits is not None:
            hard = hard != reference_bits[: self.prefix_len].bool()
        return hard.sum(dim=0, dtype=torch.int32)

    def decode_and_count(self, channel_input: torch.Tensor, bits: torch.Tensor | None = None):
        """Decode the decoder's input ``channel_input`` [n_vars, batch] and
        count its errors against the sent ``bits`` (None: the all-zeros
        codeword): (bit errors, frame errors, iterations) as device
        scalars."""
        with span("sim.decode"):
            res = self.fused_decoder(channel_input)
        with span("sim.count"):
            errors = self._count_errors(res.outputs, bits)
            return (
                errors.sum(dtype=torch.int32),
                (errors > 0).sum(dtype=torch.int32),
                res.iterations.to(torch.float32),
            )

    def n0_for(self, sigma2: float) -> float:
        """The M-ary chain's complex-noise variance: float32(2 sigma^2 / k) in
        float32 arithmetic, as the JAX engine computes it from its float32
        sigma^2."""
        f32 = np.float32
        return float(f32(f32(2.0) * f32(sigma2)) / f32(self._bits_per_symbol))

    def mary_llrs(self, codeword: torch.Tensor, noise: torch.Tensor, sigma2: float) -> torch.Tensor:
        """The exact demapper's LLRs [n_vars, batch] of ``codeword``'s QAM or
        M-PSK symbols received as y = sym + float32(sqrt(n0/2)) n, where the
        float32 normal plane ``noise`` [2 n_sym, batch] holds component c of
        symbol s in row 2s + c."""
        n_sym = codeword.shape[0] // self._bits_per_symbol
        sym = self._constellation.map(codeword)
        n0 = self.n0_for(sigma2)
        scale = float(np.float32(math.sqrt(n0 / 2.0)))
        y = sym + scale * noise.view(n_sym, 2, -1).permute(0, 2, 1)
        return demap_llrs(self._constellation, y, n0)

    @property
    def _consumer(self) -> str:
        """What the decoder reads: 'clusters' (IB), 'llrs' (quantized) or
        'true' LLRs."""
        if self.decoder == "ib":
            return "clusters"
        return "llrs" if self.llr_source == "quantized" else "true"

    @property
    def channel_input_kind(self) -> str | None:
        """The fused kind of ``rng.channel_input`` a step runs
        (``kernels/philox_planes.py`` ``FUSED``) on this chain, which
        ``rng.consume`` builds from a drawn plane; None on an M-ary chain,
        whose step draws planes and demaps with torch operators (no fused
        kind computes the demapper)."""
        if self.modulation != "bpsk":
            return None
        if self.chain == "encoded":
            return f"encoded_{self._consumer}"
        return "normal_true" if self._consumer == "true" else f"uniform_{self._consumer}"

    def _draw_step(self, qt: DeviceQuantizerTables, sigma2: float, offset: int = 0):
        """One block of codewords [offset, offset + batch) of the step whose
        key ``_step`` set: (bit errors, frame errors, iterations). One
        ``rng.channel_input`` call gives the decoder's input; the encoded
        chain first draws its info bits and encodes them."""
        batch = self.batch_per_device
        codeword = None
        with span("sim.channel_input"):
            if self.chain == "encoded":
                info = rng.draw("bits", self._key, self._info_len, offset, batch, self.device)
                with span("sim.encode"):
                    codeword = self._encode(info)
            if self.modulation != "bpsk":
                rows = 2 * self.layout.n_vars // self._bits_per_symbol
                noise = rng.draw("normal", self._key, rows, offset, batch, self.device)
                channel_input = self.mary_llrs(codeword, noise, sigma2)
            else:
                channel_input = rng.channel_input(
                    self.channel_input_kind, self._key, self.layout.n_vars, offset, batch,
                    self.device, qt, sigma2, codeword,
                )
        return self.decode_and_count(channel_input, codeword)

    def _step(self, ebn0_db: float, step_index: int, qt: DeviceQuantizerTables):
        """``steps_per_dispatch`` blocks from ``step_index`` on, without a
        host sync: summed errors and frame errors, mean iterations. In a
        process group they are this rank's shard's, all-reduced into the
        global batch's (:meth:`_all_reduce`)."""
        sigma2 = self.sigma2_for(ebn0_db)
        e = f = it = None
        for j in range(self.steps_per_dispatch):
            with span("sim.step"):
                with span("sim.seed"):
                    self._key = rng.key_words(step_seed(self.seed, ebn0_db, step_index + j))
                de, df, dit = self._draw_step(qt, sigma2, self.offset)
                e, f, it = (de, df, dit) if e is None else (e + de, f + df, it + dit)
        return self._all_reduce(e, f, it / self.steps_per_dispatch)

    def _all_reduce(self, e: torch.Tensor, f: torch.Tensor, it: torch.Tensor):
        """One dispatch's counters over all ranks, one all-reduce of one
        float64 tensor (exact for counts below 2^53): summed errors and frame
        errors and the ranks' mean of ``it``. Without a process group they
        are returned as they are."""
        if self.mesh.group is None:
            return e, f, it
        with span("sim.all_reduce"):
            total = self.mesh.all_reduce(torch.stack([e.double(), f.double(), it.double()]))
            return total[0].long(), total[1].long(), total[2] / self.n_devices

    def sigma2_for(self, ebn0_db: float) -> float:
        """The noise variance at ``ebn0_db``, rounded to float32 as the JAX
        engine passes it."""
        return float(np.float32(sigma2_from_ebn0_db(ebn0_db, self.layout.code_rate)))

    def quantizer_for(self, ebn0_db: float) -> DeviceQuantizerTables | None:
        """The channel quantizer's tables at ``ebn0_db`` on the device (built
        once per point); None on an M-ary chain, which reads none."""
        if self.modulation != "bpsk":
            return None
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
        verbose: bool = False,
        progress_every: int = 50,
        checkpoint: PointCheckpoint | None = None,
        on_progress: Callable[[PointCheckpoint], None] | None = None,
    ) -> PointResult:
        """Accumulate blocks until ``min_errors`` bit errors or at least
        ``max_blocks`` blocks (whole dispatches), from ``checkpoint`` when
        given. After each dispatch ``on_progress`` gets the state (the sweep
        persists it); with ``verbose`` a progress line is printed every
        ``progress_every`` steps. Steps are keyed by their index, so a
        resumed point counts what the uninterrupted one does."""
        with span("sim.run_point"):
            qt = self.quantizer_for(ebn0_db)
            state = checkpoint or PointCheckpoint(
                ebn0_db=float(ebn0_db), step_index=0, errors=0, frame_errors=0, blocks=0,
                iters_sum=0.0,
            )
            blocks_per_dispatch = self.batch_total * self.steps_per_dispatch
            start = time.time()
            while state.errors < min_errors and state.blocks < max_blocks:
                with span("sim.dispatch"):
                    e, f, it = self._step(ebn0_db, state.step_index, qt)
                    with span("sim.readback"):
                        e, f, it = int(e), int(f), float(it)
                state.errors += e
                state.frame_errors += f
                state.blocks += blocks_per_dispatch
                state.iters_sum += it * blocks_per_dispatch
                state.step_index += self.steps_per_dispatch
                if verbose and state.step_index % progress_every == 0:
                    elapsed = time.time() - start
                    ber = state.errors / max(state.blocks * self.prefix_len, 1)
                    rate = state.blocks * self.layout.n_vars / max(elapsed, 1e-9)
                    eta_min = ((min_errors * elapsed / max(state.errors, 1)) - elapsed) / 60
                    print(
                        f"EbN0={ebn0_db:.2f} dB errors={state.errors} "
                        f"BER~{ber:.3e} coded_bps={rate:.3e} eta_min={eta_min:.1f}",
                        flush=True,
                    )
                if on_progress is not None:
                    on_progress(state)
            elapsed = time.time() - start

            bits_counted = state.blocks * self.prefix_len
            coded_bits = state.blocks * self.layout.n_vars
            info_bits = state.blocks * self.layout.data_len
            return PointResult(
                ebn0_db=float(ebn0_db),
                ber=state.errors / max(bits_counted, 1),
                fer=state.frame_errors / max(state.blocks, 1),
                errors=state.errors,
                frame_errors=state.frame_errors,
                blocks=state.blocks,
                bits_counted=bits_counted,
                elapsed_s=elapsed,
                coded_bits_per_s=coded_bits / max(elapsed, 1e-9),
                info_bits_per_s=info_bits / max(elapsed, 1e-9),
                mean_iterations=state.iters_sum / max(state.blocks, 1),
            )
