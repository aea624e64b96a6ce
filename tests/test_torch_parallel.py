"""The port's data-parallel decoding over ``torch.distributed`` (gloo, CPU).

Each case starts its ranks as processes of their own through
``torch.distributed.run`` (``parallel.run_ranks``, program
``tests/torch_rank_jobs.py`` or the port's CLIs) with a timeout, so a hung
collective fails one test.

- World-size invariance (as ``tests/test_sim.py:58-81``): the same seed
  over a global batch of 32 split as 1 x 32, 2 x 16 and 4 x 8 counts the
  same errors and frame errors through the plain twins of K1 and K2 (tiles
  of 8, the same codewords at every split) and through ``backend='xla'``,
  whose early exit is all-reduced after every body; mean iterations equal
  on ``xla`` and within float rounding of a mean of means on the twins.
- The twins against ``xla`` at world 2 with early exit off (as
  ``:176-201``).
- The lockstep reduce against the JAX package: one seeded numpy input
  decoded whole by the JAX decoders and in two halves by two ranks.
- The CLI: ``--multihost`` in one process (as ``:204-237``), the
  two-process resume broadcast (as ``:257-335``), the dry run at world 2.
- ``n_devices`` other than the world size raises ``ValueError``.
"""

import json
import os
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from informationbottleneckdecodingldpc_tpu.codes import TannerGraph as JaxGraph
from informationbottleneckdecodingldpc_tpu.codes import regular_parity_check as jax_regular
from informationbottleneckdecodingldpc_tpu.construct import build_decoder_config as jax_build
from informationbottleneckdecodingldpc_tpu.decode import DecodeLayout as JaxLayout
from informationbottleneckdecodingldpc_tpu.decode import DeviceTrellis as JaxTrellis
from informationbottleneckdecodingldpc_tpu.decode import (
    belief_propagation_decode as jax_bp,
    ib_lut_decode as jax_ib,
    min_sum_decode as jax_minsum,
)
from informationbottleneckdecodingldpc_torch.channel import build_quantizer_tables
from informationbottleneckdecodingldpc_torch.cli import dryrun, simulate
from informationbottleneckdecodingldpc_torch.parallel import run_ranks
from torch_rank_jobs import CASES, CONFIG, FLOAT_ITERS, GLOBAL_BATCH, point, setup, simulator

from test_torch_float import BP_RTOL

REPO = Path(__file__).resolve().parents[1]
JOBS = str(Path(__file__).with_name("torch_rank_jobs.py"))
ENV = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
TIMEOUT = 120  # seconds for all ranks of one launch
LOCKSTEP_DB = 4.5  # the whole batch exits early and one half alone would exit sooner
CLI = ["-m", "informationbottleneckdecodingldpc_torch.cli.simulate",
       "--model", "regular-3-6-504", "--decoder", "minsum", "--device", "cpu",
       "--chain", "allzero", "--start-db", "3.0", "--min-errors", "5",
       "--max-iters", "4", "--max-blocks-per-point", "64"]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every case's point at worlds 1 (this process, no group), 2 and 4."""
    layout, tables = setup()
    out = {1: {f"{d}-{b}": point(simulator(layout, tables, d, b, GLOBAL_BATCH))
               for d, b in CASES}}
    for world in (2, 4):
        path = tmp_path_factory.mktemp(f"world{world}") / "points.json"
        argv = [JOBS, "points", str(GLOBAL_BATCH // world), str(path)]
        run_ranks(world, argv, TIMEOUT, env=ENV)
        out[world] = json.loads(path.read_text())
    return out


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", [f"{d}-{b}" for d, b in CASES])
def test_world_size_invariance(worlds, case, world):
    ref, got = worlds[1][case], worlds[world][case]
    assert ref[0] > 0
    assert got[:3] == ref[:3], f"{case}: world {world} counts {got}, one process {ref}"
    if case.endswith("xla"):
        assert got[3] == ref[3]  # every rank runs the whole batch's bodies
    else:
        assert got[3] == pytest.approx(ref[3], rel=1e-6)  # a mean of the ranks' means


@pytest.mark.parametrize("decoder", ["ib", "minsum"])
def test_twins_equal_xla_without_early_exit_at_world_two(worlds, decoder):
    got = worlds[2]
    assert got[f"{decoder}-fused-no-exit"][:3] == got[f"{decoder}-xla-no-exit"][:3]
    assert got[f"{decoder}-fused-no-exit"][0] > 0


def test_n_devices_other_than_the_world_size_raises(worlds):
    refused = worlds[2]["refused"]
    assert len(refused) == 2 and all("one process per card" in r for r in refused)
    layout, tables = setup()
    with pytest.raises(ValueError, match="one process per card"):
        simulator(layout, tables, "minsum", "xla", 8, n_devices=2)


@pytest.fixture(scope="module")
def lockstep(tmp_path_factory):
    """The JAX package's whole-batch decodes of one seeded input and two
    port ranks' decodes of its halves."""
    rng = np.random.default_rng(0)
    sigma2 = 10 ** (-LOCKSTEP_DB / 10) / (2 * 0.5)
    cdf = build_quantizer_tables(sigma2, 3.0, 16, CONFIG["cardinality_y_channel"]).cdf_t_given_x0
    u = rng.random((96, GLOBAL_BATCH))
    clusters = np.clip(np.searchsorted(cdf, u, side="right") - 1, 0, 15).astype(np.int32)
    y = (1 + np.sqrt(sigma2) * rng.standard_normal((96, GLOBAL_BATCH))).astype(np.float32)
    llrs = (2 * y / np.float32(sigma2)).astype(np.float32)
    tmp = tmp_path_factory.mktemp("lockstep")
    np.savez(tmp / "inputs.npz", clusters=clusters, llrs=llrs)
    run_ranks(2, [JOBS, "lockstep", str(tmp / "inputs.npz"), str(tmp / "out")], TIMEOUT,
              env=ENV)
    halves = [np.load(tmp / f"out.rank{r}.npz") for r in range(2)]
    layout = JaxLayout.from_graph(JaxGraph.from_check_matrix(jax_regular(96, 3, 6, seed=7)))
    trellis = JaxTrellis.from_tables(jax_build(**CONFIG).tables)
    decode = {
        "ib": lambda cols: jax_ib(layout, trellis, jnp.asarray(clusters[:, cols])),
        **{name: lambda cols, fn=fn: fn(layout, jnp.asarray(llrs[:, cols]), max_iters=FLOAT_ITERS)
           for name, fn in (("minsum", jax_minsum), ("bp", jax_bp))},
    }
    return decode, halves


@pytest.mark.parametrize("decoder", ["ib", "minsum", "bp"])
def test_lockstep_reduce_equals_the_jax_whole_batch(lockstep, decoder):
    decode, halves = lockstep
    ref = decode[decoder](slice(None))
    iters = [int(h[f"{decoder}_iterations"]) for h in halves]
    assert iters == [int(ref.iterations)] * 2
    assert int(ref.iterations) < FLOAT_ITERS - 1  # the whole batch left early
    # Without the reduce one half would have left sooner.
    half = GLOBAL_BATCH // 2
    alone = [int(decode[decoder](slice(r * half, (r + 1) * half)).iterations) for r in range(2)]
    assert min(alone) < int(ref.iterations), alone
    got = np.concatenate([h[f"{decoder}_outputs"] for h in halves], axis=1)
    want = np.asarray(ref.outputs)
    if decoder == "bp":
        assert np.all(np.abs(got - want) <= BP_RTOL * np.maximum(1.0, np.abs(want)))
    else:
        assert np.array_equal(got, want)  # min-sum: == also holds across the sign of zero
    unsat = np.concatenate([h[f"{decoder}_unsatisfied"] for h in halves])
    assert np.array_equal(unsat, np.asarray(ref.unsatisfied))


def test_multihost_flag_single_process(tmp_path):
    res = tmp_path / "mh.json"
    out = run_ranks(1, CLI + ["--max-db", "3.0", "--batch-per-device", "8",
                              "--results", str(res), "--multihost"], TIMEOUT, env=ENV)
    assert "multihost: process 0/1" in out
    points = json.loads(res.read_text())["points"]
    assert len(points) == 1 and points[0]["blocks"] > 0


def test_multihost_two_process_resume_broadcast(tmp_path):
    """Process 0 holds a one-point results file, process 1 a path that does
    not exist; both resume from process 0's broadcast state, process 1 writes
    nothing, and the points equal one process's run of the same global batch
    (2 x 8). The ranks join through the CLI's ``--coordinator-address``,
    ``--num-processes`` and ``--process-id``."""
    res0, ref = tmp_path / "mh2.json", tmp_path / "ref.json"
    one = CLI[2:] + ["--batch-per-device", "16"]
    simulate.main(one + ["--max-db", "3.0", "--results", str(res0)])
    assert len(json.loads(res0.read_text())["points"]) == 1
    ref_points = simulate.main(one + ["--max-db", "3.1", "--results", str(ref)])
    assert len(ref_points) == 2
    absent = tmp_path / "absent.json"
    out = run_ranks(2, [JOBS, "cli", str(res0), str(absent), *CLI[2:],
                        "--batch-per-device", "8", "--max-db", "3.1"], TIMEOUT, env=ENV)
    for r in range(2):
        assert f"multihost: process {r}/2" in out
    assert out.count("resuming sweep from the given state: 1 completed points") == 2
    assert not absent.exists()
    got = json.loads(res0.read_text())["points"]
    assert len(got) == 2
    for g, want in zip(got, ref_points):
        assert [g[k] for k in ("errors", "frame_errors", "blocks")] == \
            [want[k] for k in ("errors", "frame_errors", "blocks")]


def test_dry_run_at_world_two(monkeypatch):
    monkeypatch.setenv("PYTHONPATH", str(REPO))
    line = dryrun.main(["--world", "2", "--device", "cpu", "--timeout", str(TIMEOUT)])
    assert line.startswith("dryrun_multichip(2): ok, BER=")
    assert "over 16 codewords on 2 rank(s) (FusedIBDecoder on cpu, gloo" in line


def test_a_rank_that_fails_fails_the_launch():
    with pytest.raises(RuntimeError, match=r"2 rank\(s\) of .*: exited 1"):
        run_ranks(2, [JOBS, "points", "x", "y"], TIMEOUT, env=ENV)
