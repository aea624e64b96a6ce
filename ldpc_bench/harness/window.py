"""The timed window: dispatches through ``BERSimulator.run_point``, resumed
from a ``PointCheckpoint`` in chunks, as a sweep's extension runs a point.

``run_point`` reads each dispatch's counters back to the host and then
calls ``on_progress``; the window keeps, for every dispatch, the host clock
at that moment and the point's counters (:class:`Mark`). The first
dispatch's time runs from the window's start, each later one's from the
mark before it.

:class:`Recorder` keeps what the timed path produced for a sample of the
dispatches: each step's decoder input, the encoded chain's codewords, the
decoder's outputs and mean bodies, and the dispatch's counters as the
engine returned them. It wraps the engine's own ``_step``, decoder and
encoder; a dispatch outside the sample passes straight through.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import torch

from . import program


@dataclasses.dataclass(frozen=True)
class Mark:
    t: float  # host clock (perf_counter) once the counters were back
    errors: int
    frame_errors: int
    blocks: int
    iters_sum: float


class _Decoder:
    def __init__(self, recorder: "Recorder", inner):
        self._recorder, self._inner = recorder, inner

    def __call__(self, channel_input):
        res = self._inner(channel_input)
        rec = self._recorder.current
        if rec is not None:
            rec["inputs"].append(channel_input.clone())
            rec["outputs"].append(res.outputs.clone())
            rec["bodies"].append(res.iterations.clone())
        return res

    def __getattr__(self, name):
        return getattr(self._inner, name)


class Recorder:
    """Records the sampled dispatches ``sample`` (indices from the dispatch
    that starts at step ``first_step``) of ``sim``. With ``spans`` each
    dispatch's enqueue is a profiler range ``ldpc_bench.enqueue``."""

    def __init__(self, sim, first_step: int, sample):
        self.sim, self.first_step, self.sample = sim, first_step, set(sample)
        self.records: dict[int, dict] = {}
        self.current: dict | None = None
        self.spans = False
        self._step = sim._step
        sim._step = self._wrapped_step
        sim.fused_decoder = _Decoder(self, sim.fused_decoder)
        self._encode = sim._encode
        if self._encode is not None:
            sim._encode = self._wrapped_encode

    def _wrapped_step(self, ebn0_db, step_index, qt):
        d, r = divmod(step_index - self.first_step, self.sim.steps_per_dispatch)
        if r == 0 and d in self.sample:
            self.current = self.records.setdefault(
                d, {"inputs": [], "outputs": [], "bodies": [], "codewords": []})
        span = torch.profiler.record_function("ldpc_bench.enqueue") if self.spans else contextlib.nullcontext()
        with span:
            out = self._step(ebn0_db, step_index, qt)
        if self.current is not None:
            self.current["counters"] = out
        self.current = None
        return out

    def _wrapped_encode(self, info):
        codeword = self._encode(info)
        if self.current is not None:
            self.current["codewords"].append(codeword.clone())
        return codeword


def dispatches(sim, state, count: int, marks: list[Mark]) -> None:
    """``count`` more dispatches of the point ``state`` through ``run_point``."""
    per = sim.batch_total * sim.steps_per_dispatch
    on_progress = lambda s: marks.append(Mark(time.perf_counter(), s.errors, s.frame_errors,
                                              s.blocks, s.iters_sum))
    sim.run_point(state.ebn0_db, min_errors=2**62, max_blocks=state.blocks + count * per,
                  checkpoint=state, on_progress=on_progress)


def timed(sim, ebn0_db: float, first_step: int, seconds: float, chunk: int) -> tuple[float, list[Mark], object]:
    """Dispatches in chunks of ``chunk`` until ``seconds`` have passed: the
    window's start, its marks and the point's state."""
    state = program.checkpoint(ebn0_db, first_step)
    marks: list[Mark] = []
    t0 = time.perf_counter()
    while not marks or marks[-1].t - t0 < seconds:
        dispatches(sim, state, chunk, marks)
    return t0, marks, state


def dispatch_ms(t0: float, marks: list[Mark]) -> list[float]:
    """Each dispatch's time, from the end of the one before."""
    times = [t0] + [m.t for m in marks]
    return [(b - a) * 1e3 for a, b in zip(times, times[1:])]
