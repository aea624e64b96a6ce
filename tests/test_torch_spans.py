"""The engine's profiler spans, and the benchmark's readers of them.

On the CPU with the plain twins: under ``torch.profiler`` a ``BERSimulator``
marks each layer with a ``sim.*`` range, as many as the work and nested as
the work is; with no profiler a span is one shared no-op object and no
range is made. The readers of ``ldpc_bench/metrics/`` that use the spans
(``ldpc_bench/harness/spans.py``) are held to hand-built traces: launch
calls paired with device operations, each operation given to the innermost
span of its launch, None when the counts differ or the spans are missing.
"""

import collections
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from informationbottleneckdecodingldpc_torch.codes import TannerGraph, regular_parity_check
from informationbottleneckdecodingldpc_torch.decode import DecodeLayout
from informationbottleneckdecodingldpc_torch.encode import LDPCEncoder
from informationbottleneckdecodingldpc_torch.models import get_model
from informationbottleneckdecodingldpc_torch.sim import BERSimulator
from informationbottleneckdecodingldpc_torch.utils import profiling
from ldpc_bench.harness import spans, spec
from ldpc_bench.harness.trace import WINDOW_SPAN, Event, Trace, from_profiler

DISPATCHES, STEPS, BATCH = 2, 2, 4
NEW_METRICS = ("host_loop.first_launch_ms", "host_loop.enqueue_ms_per_step", "host_loop.launches_per_step",
               "channel_input.encoder_ms_per_step", "counting.ms_per_step")
# Each span's nearest enclosing span.
PARENT = {"sim.run_point": None, "sim.dispatch": "sim.run_point", "sim.readback": "sim.dispatch",
          "sim.step": "sim.dispatch", "sim.seed": "sim.step", "sim.channel_input": "sim.step",
          "sim.encode": "sim.channel_input", "sim.decode": "sim.step", "sim.count": "sim.step"}


def _sim(chain):
    if chain == "allzero":
        H = regular_parity_check(96, 3, 6, seed=7)
        layout, encoder = DecodeLayout.from_graph(TannerGraph.from_check_matrix(H)), None
    else:
        H = get_model("wlan-1296").make_h()
        layout, encoder = get_model("wlan-1296").make_layout(H), LDPCEncoder(H)
    return BERSimulator(layout, "minsum", device="cpu", max_iters=3, chain=chain, encoder=encoder,
                        batch_per_device=BATCH, steps_per_dispatch=STEPS, seed=11)


def _dispatches(sim, n=DISPATCHES):
    return sim.run_point(2.0, min_errors=2**62, max_blocks=n * STEPS * BATCH)


def _profiled(sim):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(WINDOW_SPAN):
            result = _dispatches(sim)
    return prof, result


def _enclosing(event):
    up = event.cpu_parent
    while up is not None and not up.name.startswith(spans.PREFIX):
        up = up.cpu_parent
    return None if up is None else up.name


@pytest.mark.parametrize("chain", ["allzero", "encoded"])
def test_spans_count_and_nest_as_the_work(chain):
    prof, result = _profiled(_sim(chain))
    assert result.blocks == DISPATCHES * STEPS * BATCH
    ours = [e for e in prof.events() if e.name.startswith(spans.PREFIX)]
    steps = DISPATCHES * STEPS
    want = {"sim.run_point": 1, "sim.dispatch": DISPATCHES, "sim.readback": DISPATCHES, "sim.step": steps,
            "sim.seed": steps, "sim.channel_input": steps, "sim.decode": steps, "sim.count": steps}
    if chain == "encoded":
        want["sim.encode"] = steps
    assert collections.Counter(e.name for e in ours) == want
    for e in ours:
        assert _enclosing(e) == PARENT[e.name], e.name


@pytest.mark.parametrize("chain", ["allzero", "encoded"])
def test_the_readers_find_the_engines_spans(chain):
    """A CPU trace has no launches and no device operations: the host loop's
    time reads, the launches read 0 (the pairing of none with none), and the
    first-launch gap, which needs a device operation, reads nothing."""
    prof, _ = _profiled(_sim(chain))
    device, host = from_profiler(prof)
    lo, hi = next((e.start, e.end) for e in host if e.name == WINDOW_SPAN)
    t = _trace(device, host, lo, hi, steps=DISPATCHES * STEPS, cell="wlan_ib.queue_enc512")
    assert spans.steps(t) == DISPATCHES * STEPS
    assert t.value("host_loop.enqueue_ms_per_step") > 0
    assert t.value("host_loop.launches_per_step") == 0
    assert t.value("counting.ms_per_step") == 0
    assert t.value("channel_input.encoder_ms_per_step") == (0 if chain == "encoded" else None)
    assert t.value("host_loop.first_launch_ms") is None


def test_spans_cost_one_check_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"a range {name!r} was made with no profiler running")

    monkeypatch.setattr(profiling, "_range", refuse)
    assert profiling.span("sim.step") is profiling.span("sim.decode")
    result = _dispatches(_sim("encoded"), n=1)
    assert result.blocks == STEPS * BATCH


def test_device_trace_shows_the_spans(tmp_path):
    with profiling.device_trace(str(tmp_path)):
        _dispatches(_sim("allzero"), n=1)
    (path,) = tmp_path.glob("*.pt.trace.json")
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert {"sim.run_point", "sim.dispatch", "sim.step", "sim.readback"} <= names


# ---------------------------------------------------------------- readers
def _trace(device, host, lo, hi, steps, cell="dvbs2_ib.queue_enc128"):
    readers = {m: spec.metric(m) for m in spec.names("metrics")}
    return Trace(device, host, lo, hi, steps=steps, batch=128, mean_bodies=49.0,
                 cell=spec.workload(cell), graph={}, readers=readers)


def _step(t0):
    """One encoded step's spans and launch calls from ``t0``: its host
    events and the names of its launches' innermost spans, in order."""
    host = [Event("sim.step", t0, t0 + 50), Event("sim.seed", t0 + 1, t0 + 5),
            Event("sim.channel_input", t0 + 6, t0 + 25), Event("cudaLaunchKernel", t0 + 7, t0 + 8),
            Event("sim.encode", t0 + 9, t0 + 18), Event("cudaLaunchKernel", t0 + 10, t0 + 11),
            Event("cudaLaunchKernelExC", t0 + 12, t0 + 13), Event("aten::gather", t0 + 14, t0 + 17),
            Event("cudaLaunchKernel", t0 + 15, t0 + 16), Event("cudaLaunchKernel", t0 + 20, t0 + 21),
            Event("sim.decode", t0 + 26, t0 + 35), Event("cudaLaunchKernel", t0 + 27, t0 + 28),
            Event("sim.count", t0 + 36, t0 + 48), Event("cudaLaunchKernel", t0 + 37, t0 + 38),
            Event("cudaMemsetAsync", t0 + 40, t0 + 41)]
    owners = ["sim.channel_input", "sim.encode", "sim.encode", "sim.encode", "sim.channel_input",
              "sim.decode", "sim.count", "sim.count"]
    return host, owners


def _window():
    """A window of two dispatches of one step each, and one device operation
    per launch call, one stream."""
    host = [Event(WINDOW_SPAN, 0.0, 1000.0), Event("sim.run_point", 1.0, 999.0)]
    owners = []
    for t0 in (10.0, 400.0):
        step, step_owners = _step(t0 + 5)
        host += [Event("sim.dispatch", t0, t0 + 300), Event("ldpc_bench.enqueue", t0 + 2, t0 + 60), *step,
                 Event("cudaLaunchKernel", t0 + 61, t0 + 62), Event("sim.readback", t0 + 100, t0 + 290),
                 Event("cudaMemcpyAsync", t0 + 101, t0 + 102), Event("cudaStreamSynchronize", t0 + 103, t0 + 289)]
        owners += step_owners + ["sim.dispatch", "sim.readback"]
    calls = sorted((e for e in host if e.name in spans.LAUNCHES), key=lambda e: e.start)
    device, t = [], 30.0
    for i, call in enumerate(calls):
        if i == 10:
            t = 420.0
        kind = {"cudaMemcpyAsync": "Memcpy DtoH", "cudaMemsetAsync": "Memset (Device)"}.get(call.name, "kernel")
        device.append(Event(f"{kind} {i}", t, t + 2.0 + i))
        t += 3.0 + i
    return host, device, owners


def _per_span(device, owners, keep=lambda i: True):
    per = collections.defaultdict(float)
    for i, (op, owner) in enumerate(zip(device, owners)):
        if keep(i):
            per[owner] += op.duration
    return per


def test_launches_pair_with_operations_and_go_to_the_innermost_span():
    host, device, owners = _window()
    t = _trace(device, host, 0.0, 1000.0, steps=2)
    pairs = spans.attribute(t)
    assert [open_[-1].name for open_ in pairs.within] == owners
    assert pairs.ops == device and not pairs.cut
    per = _per_span(device, owners)
    assert t.value("channel_input.encoder_ms_per_step") == pytest.approx(per["sim.encode"] / 1e3 / 2)
    assert t.value("counting.ms_per_step") == pytest.approx(per["sim.count"] / 1e3 / 2)
    assert pairs.device_us("sim.decode") == pytest.approx(per["sim.decode"])
    assert sum(pairs.device_us(s) for s in set(owners)) == pytest.approx(t.busy_us)
    assert t.value("host_loop.launches_per_step") == 8
    assert t.value("host_loop.enqueue_ms_per_step") == pytest.approx(50 / 1e3)


@pytest.mark.parametrize("lost", ["first", "last"])
def test_operations_lost_at_the_window_ends_leave_their_step_out(lost):
    """The device clock drifts against the host's, so the window can lose
    operations at either end: the rest pair at the one offset where the
    kinds agree, and a step with a lost operation is left out."""
    host, device, owners = _window()
    # the first step's first operation, or the second step's counting and the dispatch's tail
    kept = device[1:] if lost == "first" else device[:-4]
    t = _trace(kept, host, 0.0, 1000.0, steps=2)
    pairs = spans.attribute(t)
    assert pairs.ops == kept and len(pairs.cut) == 1
    first_step = lambda j: j < 10
    per = _per_span(device, owners, keep=(lambda j: not first_step(j)) if lost == "first" else first_step)
    assert t.value("counting.ms_per_step") == pytest.approx(per["sim.count"] / 1e3)
    assert t.value("channel_input.encoder_ms_per_step") == pytest.approx(per["sim.encode"] / 1e3)


def test_a_pairing_that_is_not_one_offset_reads_nothing():
    host, device, _ = _window()
    for kept in (device[:12] + device[13:],  # an operation lost inside the window
                 device + [Event("op", 990.0, 991.0)]):  # an operation with no launch call
        t = _trace(kept, host, 0.0, 1000.0, steps=2)
        assert spans.attribute(t) is None
        for name in ("channel_input.encoder_ms_per_step", "counting.ms_per_step"):
            assert t.value(name) is None
    # launches and the host's times need no pairing
    assert t.value("host_loop.launches_per_step") == 8


def test_first_launch_reads_the_host_clock_alone():
    host, device, _ = _window()
    # each dispatch starts 12 us before its first launch call (10 -> 22, 400 -> 412)
    for shift in (0.0, -2400.0, 2400.0):  # device times that drift against the host's
        moved = [Event(e.name, e.start + shift, e.end + shift) for e in device]
        assert _trace(moved, host, -5000.0, 5000.0, steps=2).value("host_loop.first_launch_ms") == \
            pytest.approx(12.0 / 1e3)


def test_a_program_without_spans_reads_nothing():
    host, device, _ = _window()
    bare = [e for e in host if not e.name.startswith(spans.PREFIX)]
    t = _trace(device, bare, 0.0, 1000.0, steps=2)
    assert spans.attribute(t) is not None
    for name in NEW_METRICS:
        assert t.value(name) is None, name
    # spans that miss a step of the window are not trusted either
    assert _trace(device, host, 0.0, 1000.0, steps=3).value("host_loop.enqueue_ms_per_step") is None


def test_the_encoder_metric_reads_in_the_encoded_cells():
    encoded = [w for w in spec.names("workloads") if spec.workload(w)["chain"] == "encoded"]
    assert sorted(spec.metric("channel_input.encoder_ms_per_step").WORKLOADS) == encoded
    for name in NEW_METRICS:
        if name != "channel_input.encoder_ms_per_step":
            assert spec.metric(name).WORKLOADS is None
