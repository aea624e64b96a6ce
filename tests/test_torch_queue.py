"""The port's results queue and parity report against the JAX scripts.

``scripts/queue.py`` and ``scripts/make_parity_report.py`` import only the
standard library, so they are loaded unedited (or run in a child process)
here. The port's work lists equal the JAX ones entry for entry once the
module and the paths are swapped; ``--list`` prints the same names;
``reopen_point`` writes the JSON the JAX one writes and refuses what it
refuses. On the CPU, in a temporary root: a WLAN min-sum sweep stopped by
``--max-blocks-per-point``, reopened and extended through the queue, counts
what a straight sweep counts; a failed stage stops no later stage; the
configs stage builds and then skips a config; nothing is written outside
the root. The report on copies of the JAX results equals the JAX report in
its sections and table rows, cell for cell, except one reading the JAX
report wrote by hand.
"""

import dataclasses
import glob
import importlib.util
import json
import shlex
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from informationbottleneckdecodingldpc_torch.cli import parity_report, queue, simulate
from informationbottleneckdecodingldpc_torch.construct import DecoderConfig

ROOT = Path(__file__).resolve().parents[1]
# A WLAN min-sum sweep small enough for the CPU: 2 steps of 4 codewords a
# dispatch, one point.
SMALL = ("--model wlan-1296 --decoder minsum --chain encoded --start-db 1.0 --max-db 1.0 "
         "--max-iters 3 --batch-per-device 4 --steps-per-dispatch 2 --min-errors 1000000000 "
         "--seed 21")


@pytest.fixture(scope="module")
def jax_queue():
    spec = importlib.util.spec_from_file_location("jax_queue_script", ROOT / "scripts" / "queue.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _swap(text: str) -> str:
    """A JAX command line with the port's module and paths."""
    return (text.replace("informationbottleneckdecodingldpc_tpu", "informationbottleneckdecodingldpc_torch")
            .replace("artifacts/configs", "artifacts/torch/configs")
            .replace("results/ber", "results/torch/ber"))


def test_work_lists_equal_the_jax_queue(jax_queue):
    assert queue.CONFIGS == jax_queue.CONFIGS
    assert [(s.name, s.args) for s in queue.SWEEPS] == [
        (s.name, _swap(s.args)) for s in jax_queue.SWEEPS]
    assert [dataclasses.astuple(e) for e in queue.EXTENSIONS] == [
        dataclasses.astuple(e) for e in jax_queue.EXTENSIONS]
    for mine, theirs in zip(queue.SWEEPS, jax_queue.SWEEPS):
        assert mine.results == _swap(theirs.results)
        argv = mine.argv("cuda", ("--min-errors", "5"))
        i = argv.index("--device")
        assert argv[i:i + 2] == ["--device", "cuda"]
        assert argv[:i] + argv[i + 2:] == shlex.split(_swap(theirs.cmd("--min-errors 5")))


def test_list_prints_the_jax_names(jax_queue, capsys, monkeypatch):
    queue.main(["--list"])
    mine = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["queue.py", "--list"])
    jax_queue.main()
    assert mine == capsys.readouterr().out
    assert "wlan_ib_T16_enc@2.4 -> 7000 errors" in mine


def _results(path, points, partial=None):
    payload = {"points": points}
    if partial:
        payload["partial"] = partial
    path.write_text(json.dumps(payload, indent=2))


def _point(ebn0_db, blocks, mean_iterations=7.25):
    return dict(ebn0_db=ebn0_db, ber=0.01, fer=0.1, errors=300 + blocks, frame_errors=blocks // 10,
                blocks=blocks, bits_counted=blocks * 648, elapsed_s=1.5,
                coded_bits_per_s=1e6, info_bits_per_s=5e5, mean_iterations=mean_iterations)


def test_reopen_point_writes_what_the_jax_queue_writes(jax_queue, tmp_path):
    pts = [_point(0.6, 512), _point(0.7, 1024, 11.123456789)]
    for reopen, name in ((queue.reopen_point, "port.json"), (jax_queue.reopen_point, "jax.json")):
        _results(tmp_path / name, pts)
        assert reopen(str(tmp_path / name), 0.7, 512) is True
        assert reopen(str(tmp_path / name), 0.9, 512) is False  # no such point
    assert (tmp_path / "port.json").read_text() == (tmp_path / "jax.json").read_text()
    partial = json.loads((tmp_path / "port.json").read_text())["partial"]
    assert partial["step_index"] == 2 and partial["blocks"] == 1024


def test_reopen_point_refuses_as_the_jax_queue_does(jax_queue, tmp_path):
    for reopen, name in ((queue.reopen_point, "port.json"), (jax_queue.reopen_point, "jax.json")):
        _results(tmp_path / name, [_point(0.6, 512), _point(0.7, 512)])
        with pytest.raises(SystemExit, match="later points exist"):
            reopen(str(tmp_path / name), 0.6, 512)
    with pytest.raises(ValueError, match="must match"):
        queue.reopen_point(str(tmp_path / "port.json"), 0.7, 300)


def _counters(path, ebn0_db):
    (p,) = [p for p in json.loads(Path(path).read_text())["points"] if p["ebn0_db"] == ebn0_db]
    return p


def test_reopened_and_extended_point_equals_a_straight_run(tmp_path):
    root = tmp_path / "root"
    stopped = queue.Sweep("qtest_minsum", SMALL + " --max-blocks-per-point 8")
    assert queue.run(["sweeps"], [], [stopped], [], root, "cpu") == []
    first = _counters(root / stopped.results, 1.0)
    assert first["blocks"] == 8
    extend = queue.Extension("qtest_minsum", 1.0, 10**9, 16, 4)
    assert queue.run(["extend"], [], [stopped], [extend], root, "cpu") == []
    (want,) = simulate.main(shlex.split(SMALL) + [
        "--max-blocks-per-point", "16", "--device", "cpu", "--results", str(tmp_path / "straight.json")])
    got = _counters(root / stopped.results, 1.0)
    for k in ("errors", "frame_errors", "blocks", "bits_counted"):
        assert got[k] == want[k], k
    assert got["blocks"] == 16 and got["errors"] > first["errors"]
    assert abs(got["mean_iterations"] - want["mean_iterations"]) <= 1e-9
    # Every output lies under the root: results, exports and logs.
    assert {p.name for p in (root / queue.BER_DIR).iterdir()} == {
        f"qtest_minsum.{x}" for x in ("json", "npz", "png")}
    assert {p.name for p in (root / queue.LOG_DIR).iterdir()} == {
        "sweep_qtest_minsum.log", "extend_qtest_minsum.log"}
    # Nothing of it in the checkout.
    for d in ("results", "artifacts"):
        assert not glob.glob(str(ROOT / d / "**" / "qtest_*"), recursive=True)


def test_a_failed_stage_stops_no_later_stage(tmp_path, capsys):
    root = tmp_path / "root"
    # No sweep has run in this root, so there is no point to extend; the report still runs.
    with pytest.raises(SystemExit, match="failed stages: extend$"):
        queue.main(["--stages", "extend,report", "--device", "cpu", "--root", str(root)])
    assert "stage extend FAILED: FileNotFoundError" in capsys.readouterr().out
    text = (root / "results/torch/PARITY.md").read_text()
    assert "## WLAN 802.11n N=1296 — IB LUT |T|=16, encoded chain, i_max=50\n\n_(not yet run)_" in text
    with pytest.raises(ValueError, match="unknown stages"):
        queue.run(["sweep"], [], [], [], root, "cpu")


def test_configs_stage_builds_then_skips(tmp_path, capsys):
    root = tmp_path / "root"
    configs = [("qtest_regular", "--model regular-3-6-504 --ebn0 2.0 --i-max 4")]
    assert queue.run(["configs"], configs, [], [], root, "cpu") == []
    cfg = DecoderConfig.load(str(root / queue.CFG_DIR / "qtest_regular.npz"))
    assert cfg.tables.i_max == 4 and cfg.design_ebn0_db == 2.0
    assert (root / queue.CFG_DIR / "qtest_regular_exit.png").exists()
    assert queue.run(["configs"], configs, [], [], root, "cpu") == []
    assert "config qtest_regular: exists" in capsys.readouterr().out


def test_exit_chart_skips_without_matplotlib(tmp_path, capsys, monkeypatch):
    cfg = DecoderConfig.load(str(ROOT / "results/configs/wlan_T16_0.8.npz"))
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import raises ImportError
    cfg.export_exit_chart(str(tmp_path / "exit.png"))
    assert not (tmp_path / "exit.png").exists()
    assert "no matplotlib" in capsys.readouterr().out


def _tables(text: str) -> list[list[str]]:
    """Every section heading and the cells of every table row."""
    out = []
    for line in text.splitlines():
        s = line.strip()
        if s.startswith("#"):
            out.append([s])
        elif s.startswith("|"):
            out.append([c.strip() for c in s.strip("|").split(" | ")])
    return out


def test_report_equals_the_jax_report_on_its_results(tmp_path):
    (tmp_path / "results").mkdir()
    shutil.copytree(ROOT / "results/ber", tmp_path / "results/ber",
                    ignore=shutil.ignore_patterns("*.npz", "*.png"))
    shutil.copy(ROOT / "results/THRESHOLDS.json", tmp_path / "results")
    subprocess.run([sys.executable, str(ROOT / "scripts/make_parity_report.py")], cwd=tmp_path,
                   check=True, capture_output=True, timeout=120)
    want = _tables((tmp_path / "PARITY.md").read_text())
    out = tmp_path / "port" / "PARITY.md"
    text = parity_report.main(["--results-dir", str(tmp_path / "results/ber"), "--thresholds",
                               str(tmp_path / "results/THRESHOLDS.json"), "--out", str(out)])
    assert out.read_text() == text
    got = _tables(text)
    assert len(got) == len(want) and len(want) > 200
    # The JAX report's one hand-written reading: regular IB @1.25 dB sits
    # 2.0912 - 1.7415 = 0.35 dB left of min-sum at BER 1e-4 (written 0.4).
    hand = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
    assert len(hand) == 1
    assert got[hand[0]][:3] == want[hand[0]][:3]
    assert got[hand[0]][3] == want[hand[0]][3].replace("sits 0.4 dB LEFT", "sits 0.3 dB LEFT")
    if shutil.which("nvidia-smi") is None:
        assert "Card: card not recorded." in text
    assert "TPU" not in text
