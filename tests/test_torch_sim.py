"""The PyTorch port's Monte-Carlo step, engine and CLI.

The whole slice: one numpy uniform plane goes through the JAX chain
(inversion sampling, the XLA decoder of an ``xla``-backend BERSimulator,
its error counting) and through the port's ``rng.consume`` and
``decode_and_count``; the counters must be equal. ``run_point`` and the
CLI run at a tiny size on the CPU. The port must import with ``jax``
blocked.
"""

import dataclasses
import json
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from informationbottleneckdecodingldpc_tpu.channel.quantizer import (
    sample_clusters_from_uniform as jax_sample,
)
from informationbottleneckdecodingldpc_tpu.construct import DecoderConfig as JaxConfig
from informationbottleneckdecodingldpc_tpu.decode import DeviceTrellis as JaxTrellis
from informationbottleneckdecodingldpc_tpu.models import get_model as jax_model
from informationbottleneckdecodingldpc_tpu.sim import BERSimulator as JaxSimulator
from informationbottleneckdecodingldpc_tpu.sim.engine import PointResult as JaxPoint
from informationbottleneckdecodingldpc_torch.cli import simulate
from informationbottleneckdecodingldpc_torch.construct import DecoderConfig
from informationbottleneckdecodingldpc_torch.decode import DeviceTrellis
from informationbottleneckdecodingldpc_torch.encode import LDPCEncoder
from informationbottleneckdecodingldpc_torch.models import get_model
from informationbottleneckdecodingldpc_torch.sim import BERSimulator
from informationbottleneckdecodingldpc_torch.sim.engine import step_seed
from informationbottleneckdecodingldpc_torch.sim.rng import consume
from informationbottleneckdecodingldpc_torch.utils import (
    HEADLINE,
    MATRIX,
    build_headline_sim,
    build_matrix_sim,
)

CONFIG = "results/configs/wlan_T16_0.8.npz"
JAX_POINT_KEYS = {f.name for f in dataclasses.fields(JaxPoint)}


@pytest.fixture(scope="module")
def wlan():
    cfg = DecoderConfig.load(CONFIG)
    return get_model("wlan-1296").make_layout(), cfg


def _port_sim(wlan, **kw):
    layout, cfg = wlan
    args = dict(
        trellis=DeviceTrellis.from_tables(cfg.tables, "cpu"),
        device="cpu",
        cardinality_t_channel=16,
        cardinality_y_channel=400,
        batch_per_device=4,
    )
    args.update(kw)
    return BERSimulator(layout, "ib", **args)


@pytest.mark.parametrize("ebn0_db, max_iters", [(0.8, 5), (6.0, 50)])
def test_a_uniform_plane_step_matches_jax_chain(wlan, ebn0_db, max_iters):
    batch = 8
    # One tile of the whole batch: the fused twin runs in whole-batch
    # lockstep, as the JAX XLA decoder does.
    sim = _port_sim(
        wlan,
        max_iters=max_iters,
        cardinality_y_channel=2000,
        batch_per_device=batch,
        batch_tile=batch,
    )
    jsim = JaxSimulator(
        jax_model("wlan-1296").make_layout(),
        "ib",
        trellis=JaxTrellis.from_tables(JaxConfig.load(CONFIG).tables),
        max_iters=max_iters,
        chain="allzero",
        cardinality_t_channel=16,
        cardinality_y_channel=2000,
        batch_per_device=batch,
        n_devices=1,
        backend="xla",
    )
    u = np.random.default_rng(0).random((sim.layout.n_vars, batch), dtype=np.float32)

    qt = sim.quantizer_for(ebn0_db)
    jqt = jsim.quantizer_for(ebn0_db)
    for got, want in zip(qt, jqt):
        assert np.array_equal(got.numpy(), np.asarray(want))
    errors, frame_errors, iterations = sim.decode_and_count(
        consume(sim.channel_input_kind, torch.as_tensor(u), qt))

    zeros = jnp.zeros(u.shape, jnp.int32)
    res = jsim._decode(jax_sample(jqt.cdf, jnp.asarray(u), zeros), None)
    per_cw = jsim._count_errors(res.outputs, zeros)
    assert int(errors) == int(jnp.sum(per_cw))
    assert int(frame_errors) == int(jnp.sum(per_cw > 0))
    assert float(iterations) == float(res.iterations)
    if ebn0_db == 6.0:
        assert int(iterations) < max_iters - 1  # early exit fired


def test_run_point_keys_and_counters(wlan):
    sim = _port_sim(wlan, max_iters=3, steps_per_dispatch=2)
    r = sim.run_point(1.0, min_errors=1, max_blocks=8)
    assert set(r.to_dict()) == JAX_POINT_KEYS
    assert r.blocks == 8 and r.bits_counted == 8 * sim.layout.data_len
    assert 0 <= r.errors <= r.bits_counted and 0 <= r.frame_errors <= r.blocks
    assert r.ber == r.errors / r.bits_counted
    assert r.mean_iterations == 2.0  # max_iters - 1, the loop never converges


def test_counters_do_not_depend_on_steps_per_dispatch(wlan):
    one = _port_sim(wlan, max_iters=3, steps_per_dispatch=1).run_point(
        2.0, min_errors=10**9, max_blocks=8
    )
    two = _port_sim(wlan, max_iters=3, steps_per_dispatch=2).run_point(
        2.0, min_errors=10**9, max_blocks=8
    )
    assert (one.errors, one.frame_errors, one.blocks) == (
        two.errors, two.frame_errors, two.blocks,
    )


def test_quantize_with_matches_jax():
    from informationbottleneckdecodingldpc_tpu.channel import quantizer as jq
    from informationbottleneckdecodingldpc_torch.channel import (
        build_quantizer_tables,
        device_tables,
        quantize_with,
    )

    y = np.random.default_rng(4).normal(1.0, 0.7, (96, 6)).astype(np.float32)
    y[0, :3] = [0.0, -3.5, 3.5]  # the middle border and both clip regions
    limits = device_tables(build_quantizer_tables(0.5, 3.0, 16, 400), "cpu").limits
    got = quantize_with(limits, torch.as_tensor(y))
    jax_limits = jq.device_tables(jq.build_quantizer_tables(0.5, 3.0, 16, 400)).limits
    want = jq.quantize_with(jax_limits, jnp.asarray(y))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_step_seed_depends_on_seed_snr_and_step():
    seeds = {
        step_seed(s, db, k) for s in (0, 1) for db in (0.8, 0.9, -1.0) for k in (0, 1)
    }
    assert len(seeds) == 12
    assert all(0 <= s < 2**63 for s in seeds)


@pytest.mark.parametrize(
    "kw, error, match",
    [
        # The M-ary chains are ported: what they refuse, they refuse with the
        # JAX engine's ValueErrors.
        (dict(modulation="qam", mod_order=4, chain="encoded", llr_source="true"), ValueError,
         "float decoder"),  # IB with QAM
        (dict(decoder="minsum", max_iters=5, modulation="qam", mod_order=4, chain="encoded"),
         ValueError, "llr_source='true'"),  # quantized LLRs with QAM
        (dict(decoder="minsum", max_iters=5, llr_source="true", modulation="mpsk", mod_order=8),
         ValueError, "encoded chain"),  # the all-zeros chain with M-PSK
    ],
)
def test_unported_paths_raise_naming_their_roadmap_item(wlan, kw, error, match):
    layout, cfg = wlan
    args = dict(trellis=DeviceTrellis.from_tables(cfg.tables, "cpu"), device="cpu")
    decoder = kw.pop("decoder", "ib")
    args.update(kw)
    if args.get("chain") == "encoded":
        args["encoder"] = LDPCEncoder(get_model("wlan-1296").make_h())
    with pytest.raises(error, match=match):
        BERSimulator(layout, decoder, **args)


def test_cli_writes_points_with_the_jax_keys(tmp_path):
    out = tmp_path / "points.json"
    simulate.main([
        "--model", "wlan-1296", "--config", CONFIG, "--device", "cpu",
        "--start-db", "1.0", "--max-db", "1.5", "--step-db", "0.5",
        "--max-iters", "3", "--batch-per-device", "4", "--min-errors", "1",
        "--max-blocks-per-point", "4", "--results", str(out),
    ])
    points = json.loads(out.read_text())["points"]
    assert [p["ebn0_db"] for p in points] == [1.0, 1.5]
    assert all(set(p) == JAX_POINT_KEYS for p in points)
    assert all(p["blocks"] == 4 for p in points)


def test_cli_on_cuda_raises_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        simulate.main([
            "--model", "wlan-1296", "--config", CONFIG,
            "--results", str(tmp_path / "x.json"),
        ])


def test_headline_matches_the_jax_headline():
    from informationbottleneckdecodingldpc_tpu.utils.benchmarks import (
        HEADLINE as JAX_HEADLINE,
    )

    assert HEADLINE == JAX_HEADLINE


def test_the_headline_is_the_matrix_wlan_ib_fused_cell():
    cell = MATRIX["wlan_ib_fused"]
    for key in ("model", "config", "decoder", "backend"):
        assert HEADLINE[key] == cell[key]
    assert HEADLINE["chain"] == cell.get("chain", "allzero")
    assert (HEADLINE["batch"], HEADLINE["steps_per_dispatch"]) == (cell["batch"], cell["steps"])

    def settings(sim):
        return (sim.decoder, sim.backend, sim.chain, sim.llr_source, sim.count_all_bits,
                sim.batch_per_device, sim.steps_per_dispatch, sim.seed, sim.max_iters,
                sim.cardinality_t_channel, sim.layout.n_vars, type(sim.fused_decoder).__name__)

    sim, ebn0_db, tables = build_matrix_sim("wlan_ib_fused", "cpu")
    headline = build_headline_sim("cpu")
    assert settings(headline) == settings(sim)
    assert ebn0_db == HEADLINE["ebn0_db"] and tables.cardinality_t_channel == 16
    assert settings(sim)[:7] == (HEADLINE["decoder"], HEADLINE["backend"], HEADLINE["chain"],
                                 "quantized", False, HEADLINE["batch"],
                                 HEADLINE["steps_per_dispatch"])
    assert build_headline_sim("cpu", batch_per_device=8).batch_per_device == 8


def test_port_imports_without_jax():
    """Every module of the port imports with jax, jaxlib and the JAX package
    blocked, and none of them is loaded after."""
    code = textwrap.dedent(
        """
        import importlib, pkgutil, sys

        BLOCKED = ("jax", "jaxlib", "informationbottleneckdecodingldpc_tpu")

        class BlockJax:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError("blocked: " + name)

        sys.meta_path.insert(0, BlockJax())
        import informationbottleneckdecodingldpc_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        assert not any(m.split(".")[0] in BLOCKED for m in sys.modules)
        p = pkg.__name__ + "."
        assert {
            p + "kernels.ib_lut_hbm", p + "kernels.float_hbm", p + "kernels.peaks",
            p + "kernels.hbm_copy", p + "utils.roofline", p + "utils.peaks",
            p + "cli.bench_matrix", p + "codes.graph", p + "ib.dp_quantizer",
            p + "encode.gf2", p + "utils.bitpack", p + "models.zoo",
            p + "sim.rng", p + "kernels.philox_planes", p + "kernels.stage_chunks",
            p + "kernels.stage_replay", p + "utils.probes", p + "cli.probes",
            p + "channel.demap", p + "channel.modulation", p + "sim.sweep", p + "sim.results",
            p + "utils.profiling", p + "cli.simulate", p + "cli.ib_exit",
            p + "parallel.mesh", p + "cli.dryrun", p + "cli.construct", p + "ib.sib",
            p + "construct.matching", p + "construct.density_evolution",
            p + "construct.density_evolution_irreg", p + "construct.awgn_dde",
            p + "models.artifacts", p + "cli.queue", p + "cli.parity_report",
            p + "decode.factories",
        } <= set(names)
        print(len(names))
        """
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 40
