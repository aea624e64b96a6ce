"""The PyTorch port's resumable sweep, results files, exports, full CLI and
trace against the JAX package.

At a tiny size on the CPU: a sweep persists every point and resumes after
the last one; a point stopped mid-way and resumed from its saved counters
equals the uninterrupted point bit for bit (the draws are keyed per step and
codeword); the JAX package's ``load_results`` reads the port's results
file; the .npz and .mat exports hold the JAX keys; the CLI's
``--modulation`` parsing gives what the JAX CLI's does, and its usage errors
the same messages; ``device_trace`` writes a Chrome trace. The committed
16-QAM curve of the port (``results/torch/ber/wlan_minsum_qam16.json``, made on
the card through the CLI) agrees with the JAX package's curve at every
Eb/N0 both hold: FER within 3 standard deviations of the two binomial
samples at their pooled rate (:func:`curve_rows` gives the table of
PERF.md).
"""

import dataclasses
import glob
import json
import math
import os

import numpy as np
import pytest
import scipy.io as sio
import torch

from informationbottleneckdecodingldpc_tpu.cli import simulate as jax_cli
from informationbottleneckdecodingldpc_tpu.sim import results as jax_results
from informationbottleneckdecodingldpc_torch.cli import simulate
from informationbottleneckdecodingldpc_torch.codes import TannerGraph, regular_parity_check
from informationbottleneckdecodingldpc_torch.decode import DecodeLayout
from informationbottleneckdecodingldpc_torch.encode import LDPCEncoder
from informationbottleneckdecodingldpc_torch.models import get_model
from informationbottleneckdecodingldpc_torch.sim import (
    BERSimulator,
    PointCheckpoint,
    PointResult,
    SweepController,
    SweepSchedule,
    load_results,
)
from informationbottleneckdecodingldpc_torch.sim import results
from informationbottleneckdecodingldpc_torch.utils.profiling import device_trace


@pytest.fixture(scope="module")
def small_layout():
    H = regular_parity_check(96, 3, 6, seed=7)
    return DecodeLayout.from_graph(TannerGraph.from_check_matrix(H))


def _minsum(layout, seed=5):
    return BERSimulator(layout, "minsum", device="cpu", max_iters=8, chain="allzero",
                        count_all_bits=True, batch_per_device=16, seed=seed)


def test_sweep_persists_and_resumes(small_layout, tmp_path):
    path = str(tmp_path / "sweep.json")
    sched = SweepSchedule(start_db=2.0, normal_step_db=0.5, max_db=2.5, target_ber=1e-9,
                          min_errors=20, max_blocks_per_point=320)
    got = SweepController(_minsum(small_layout), sched, results_path=path, verbose=False).run()
    assert [r.ebn0_db for r in got] == [2.0, 2.5]
    assert [r.ebn0_db for r in load_results(path)] == [2.0, 2.5]
    # Complete: a rerun computes nothing.
    again = SweepController(_minsum(small_layout), sched, results_path=path, verbose=False).run()
    assert [r.to_dict() for r in again] == [r.to_dict() for r in got]
    # A higher cap resumes after the last point and keeps the first two as saved.
    more = dataclasses.replace(sched, max_db=3.0)
    out = SweepController(_minsum(small_layout), more, results_path=path, verbose=False).run()
    assert [r.ebn0_db for r in out] == [2.0, 2.5, 3.0]
    assert [r.to_dict() for r in out[:2]] == [r.to_dict() for r in got]
    # The state a caller passes in stands in for the file; nothing is written.
    state = json.loads(open(path).read())
    ctrl = SweepController(_minsum(small_layout), dataclasses.replace(more, max_db=3.5),
                           results_path=str(tmp_path / "none.json"), verbose=False,
                           write_results=False, resume_state=state)
    assert [r.ebn0_db for r in ctrl.run()] == [2.0, 2.5, 3.0, 3.5]
    assert not (tmp_path / "none.json").exists()


def test_sweep_stops_at_the_target_ber(small_layout, tmp_path):
    sched = SweepSchedule(start_db=2.0, normal_step_db=0.5, max_db=9.0, target_ber=0.5,
                          min_errors=20, max_blocks_per_point=32)
    got = SweepController(_minsum(small_layout), sched, verbose=False).run()
    assert len(got) == 1 and got[0].ber <= 0.5


class _Stop(Exception):
    pass


@pytest.mark.parametrize("chain", ["allzero_minsum", "encoded_qam16"])
def test_midpoint_checkpoint_resume_exact(small_layout, tmp_path, chain):
    """A point stopped after two dispatches and resumed from its saved
    ``partial`` counts what the uninterrupted point counts."""
    if chain == "allzero_minsum":
        mk, ebn0, kw = lambda: _minsum(small_layout, seed=3), 2.0, dict(min_errors=300,
                                                                       max_blocks=160)
    else:
        H = get_model("wlan-1296").make_h()
        layout, enc = get_model("wlan-1296").make_layout(H), LDPCEncoder(H)
        mk = lambda: BERSimulator(layout, "minsum", device="cpu", max_iters=3, chain="encoded",
                                  llr_source="true", modulation="qam", mod_order=4,
                                  encoder=enc, batch_per_device=4, seed=3)
        ebn0, kw = 3.0, dict(min_errors=10**9, max_blocks=16)
    full = mk().run_point(ebn0, **kw)

    snap = {}

    def grab(state):
        snap.update(dataclasses.asdict(state))
        if state.step_index >= 2:
            raise _Stop

    with pytest.raises(_Stop):
        mk().run_point(ebn0, on_progress=grab, **kw)
    path = str(tmp_path / "res.json")
    results.save_results(path, [], partial=snap)
    resumed = mk().run_point(ebn0, checkpoint=PointCheckpoint(**results.load_partial(path)), **kw)
    for key in ("errors", "frame_errors", "blocks", "bits_counted", "ber", "fer",
                "mean_iterations"):
        assert getattr(resumed, key) == getattr(full, key)


def test_run_point_prints_progress(small_layout, capsys):
    _minsum(small_layout).run_point(2.0, min_errors=10**9, max_blocks=64, verbose=True,
                                    progress_every=2)
    lines = [l for l in capsys.readouterr().out.splitlines() if l.startswith("EbN0=2.00 dB")]
    assert len(lines) == 2 and "BER~" in lines[0] and "eta_min=" in lines[0]


def _points():
    return [PointResult(ebn0_db=db, ber=0.01 / (k + 1), fer=0.2 / (k + 1), errors=10 - k,
                        frame_errors=3, blocks=64, bits_counted=64 * 48, elapsed_s=0.5,
                        coded_bits_per_s=1e6, info_bits_per_s=5e5, mean_iterations=7.25)
            for k, db in enumerate((1.0, 1.5))]


def test_the_jax_package_reads_the_ports_results_file(tmp_path):
    path = str(tmp_path / "r.json")
    partial = dataclasses.asdict(PointCheckpoint(2.0, 50, 4, 1, 800, 96.0))
    results.save_results(path, _points(), partial=partial)
    assert [p.to_dict() for p in jax_results.load_results(path)] == [
        p.to_dict() for p in _points()]
    assert jax_results.load_partial(path) == partial
    # And the other way round.
    jax_path = str(tmp_path / "j.json")
    jax_results.save_results(jax_path, jax_results.load_results(path), partial=partial)
    assert open(jax_path).read() == open(path).read()


def curve_rows(port: str, reference: str) -> list[dict]:
    """One row per Eb/N0 in both results files: FER and BER of both, the
    FER difference in standard deviations of the two samples at their pooled
    rate, and the BER ratio."""
    ref = {round(r.ebn0_db, 6): r for r in results.load_results(reference)}
    rows = []
    for p in results.load_results(port):
        r = ref.get(round(p.ebn0_db, 6))
        if r is None:
            continue
        pooled = (p.frame_errors + r.frame_errors) / (p.blocks + r.blocks)
        sd = math.sqrt(pooled * (1 - pooled) * (1 / p.blocks + 1 / r.blocks))
        rows.append(dict(ebn0_db=p.ebn0_db, fer=p.fer, fer_ref=r.fer, blocks=p.blocks,
                         blocks_ref=r.blocks, fer_sigmas=(p.fer - r.fer) / sd if sd else 0.0,
                         ber=p.ber, ber_ref=r.ber, ber_ratio=p.ber / r.ber if r.ber else math.nan))
    return rows


def test_qam16_curve_agrees_with_the_jax_curve():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    rows = curve_rows(os.path.join(root, "results/torch/ber/wlan_minsum_qam16.json"),
                      os.path.join(root, "results/ber/wlan_minsum_qam16.json"))
    assert len(rows) == 36
    assert max(abs(r["fer_sigmas"]) for r in rows) < 3.0
    assert {r["ebn0_db"] for r in rows} >= {3.5, 4.2}


def test_exports_hold_the_jax_keys(tmp_path):
    for fmt in ("npz", "mat"):
        mine, theirs = str(tmp_path / f"port.{fmt}"), str(tmp_path / f"jax.{fmt}")
        if fmt == "npz":
            results.export_npz(mine, _points())
            jax_results.export_npz(theirs, _points())
            a, b = np.load(mine), np.load(theirs)
        else:
            results.export_mat(mine, _points(), decoder_name="wlan-1296")
            jax_results.export_mat(theirs, _points(), decoder_name="wlan-1296")
            a, b = sio.loadmat(mine), sio.loadmat(theirs)
        keys = {k for k in a.keys() if not k.startswith("__")}
        assert keys == {k for k in b.keys() if not k.startswith("__")}
        for k in keys:
            assert np.array_equal(a[k], b[k])


def _parsed(main, argv, monkeypatch, module):
    """What the CLI's ``main`` hands the simulator, stopped there; or the
    usage error it exits with."""

    class Built(Exception):
        pass

    def capture(*args, **kw):
        raise Built(kw)

    monkeypatch.setattr(module, "BERSimulator", capture)
    try:
        main(argv)
    except Built as b:
        kw = b.args[0]
        return kw["modulation"], kw["mod_order"], kw["llr_source"]
    except SystemExit as e:
        return ("exit", e.code)


@pytest.mark.parametrize("modulation", ["bpsk", "qam4", "qam16", "qam64", "psk4", "psk8",
                                        "psk32", "qam8", "psk6", "qam2", "fsk4", "qam", "psk"])
def test_cli_modulation_parsing_equals_jax(modulation, monkeypatch, capsys, tmp_path):
    common = ["--model", "wlan-1296", "--decoder", "minsum", "--chain", "encoded",
              "--modulation", modulation, "--results", str(tmp_path / "x.json")]
    got = _parsed(simulate.main, common + ["--device", "cpu"], monkeypatch, simulate)
    port_err = capsys.readouterr().err.strip().splitlines()[-1:]
    want = _parsed(jax_cli.main, common, monkeypatch, jax_cli)
    jax_err = capsys.readouterr().err.strip().splitlines()[-1:]
    assert got == want
    if got[0] == "exit":
        assert port_err == jax_err and "error:" in port_err[0]
    elif modulation != "bpsk":
        assert got[2] == "true"  # M-ary implies true LLRs


def test_cli_sweeps_resumes_and_exports(tmp_path):
    out, npz = tmp_path / "psk8.json", tmp_path / "psk8.npz"
    argv = ["--model", "wlan-1296", "--decoder", "minsum", "--chain", "encoded",
            "--modulation", "psk8", "--device", "cpu", "--start-db", "3.0", "--step-db", "0.5",
            "--max-iters", "3", "--batch-per-device", "4", "--min-errors", "1",
            "--max-blocks-per-point", "4", "--results", str(out)]
    first = simulate.main(argv + ["--max-db", "3.5"])
    assert [p["ebn0_db"] for p in first] == [3.0, 3.5]
    second = simulate.main(argv + ["--max-db", "4.0", "--export-npz", str(npz),
                                   "--export-mat", str(tmp_path / "psk8.mat")])
    assert second[:2] == first and [p["ebn0_db"] for p in second] == [3.0, 3.5, 4.0]
    assert set(np.load(npz).keys()) == {"EbN0_dB_vector", "BER_vector", "FER_vector"}
    assert [p.ebn0_db for p in jax_results.load_results(str(out))] == [3.0, 3.5, 4.0]


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with device_trace(str(tmp_path / "trace")):
        torch.ones(64).cumsum(0)
    files = glob.glob(str(tmp_path / "trace" / "*.pt.trace.json"))
    assert len(files) == 1 and "traceEvents" in json.loads(open(files[0]).read())
    with device_trace(None):
        pass
