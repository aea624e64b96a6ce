"""The port's decoder construction (its numpy copy of the JAX package's
``construct/``, ``ib/sib.py``, ``models/artifacts.py`` and
``cli/construct.py``) against the JAX package.

Each copy runs on ``tests/test_construct.py``'s settings beside its JAX
module and every array must be equal: message alignment, regular and
irregular density evolution (tables, matching vectors, the MI trajectory and
every diagnostic), the reference's flat layout, the sequential IB. A config
saved by one package loads in the other. The port rebuilds three of the
committed configs in ``results/configs/`` with every array equal (the
fourth, ``wlan_T32_0.6``, takes about 20 s here and is rebuilt by
``chip_smoke.py`` phase 38).
"""

import numpy as np
import pytest

from informationbottleneckdecodingldpc_tpu.cli import construct as jax_cli
from informationbottleneckdecodingldpc_tpu.codes import dvbs2_like_parity_check as jax_irregular
from informationbottleneckdecodingldpc_tpu.construct import DecoderConfig as JaxConfig
from informationbottleneckdecodingldpc_tpu.construct import TrellisTables as JaxTables
from informationbottleneckdecodingldpc_tpu.construct import build_decoder_config as jax_build
from informationbottleneckdecodingldpc_tpu.construct import information_matching as jax_matching
from informationbottleneckdecodingldpc_tpu.ib import sib as jax_sib
from informationbottleneckdecodingldpc_torch.cli import construct as port_cli
from informationbottleneckdecodingldpc_torch.codes import dvbs2_like_parity_check
from informationbottleneckdecodingldpc_torch.construct import (
    DecoderConfig,
    TrellisTables,
    build_decoder_config,
    information_matching,
)
from informationbottleneckdecodingldpc_torch.construct import config as port_config
from informationbottleneckdecodingldpc_torch.ib import sib as port_sib
from informationbottleneckdecodingldpc_torch.models import artifacts, get_model
from informationbottleneckdecodingldpc_torch.utils.benchmarks import (
    COMMITTED_CONFIGS,
    CONFIG_DIR,
    rebuild_committed_config,
)

# tests/test_construct.py's regular config, and a small irregular one.
REGULAR = dict(design_ebn0_db=2.0, cardinality_y_channel=600, cardinality_t_channel=16,
               cardinality_t_decoder=16, i_max=10, d_v=3, d_c=6)
IRREGULAR = dict(design_ebn0_db=1.5, cardinality_y_channel=400, cardinality_t_channel=16,
                 cardinality_t_decoder=16, i_max=6)
# wlan_T32_0.6 (about 20 s here) is rebuilt by chip_smoke.py phase 38.
REBUILT_HERE = sorted(set(COMMITTED_CONFIGS) - {"wlan_T32_0.6"})


def arrays(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def assert_same_arrays(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k


def saved(cfg, path) -> dict:
    cfg.save(str(path))
    return arrays(path)


def build_both(kind: str):
    """The same construction in both packages: (port config, JAX config)."""
    if kind == "regular":
        return build_decoder_config(**REGULAR), jax_build(**REGULAR)
    if kind == "regular-sib":
        kw = dict(REGULAR, i_max=4, ib_backend="sib", ib_nror=3, ib_seed=5)
        return build_decoder_config(**kw), jax_build(**kw)
    return (build_decoder_config(H=dvbs2_like_parity_check(1920, 960, seed=9), **IRREGULAR),
            jax_build(H=jax_irregular(1920, 960, seed=9), **IRREGULAR))


@pytest.mark.parametrize("case", ["identity", "random"])
def test_information_matching_equals_jax(case):
    rng = np.random.default_rng(1)
    if case == "identity":
        p_t = p_z = np.array([[0.4, 0.1], [0.1, 0.4]])
    else:
        p_t, p_z = (rng.random((8, 2)) + 0.05 for _ in range(2))
        p_t, p_z = p_t / p_t.sum(), p_z / p_z.sum()
    k = p_t.shape[0]
    got, want = information_matching(k, p_t, p_z), jax_matching(k, p_t, p_z)
    assert np.array_equal(got.lut, want.lut)
    for field in ("p_x_given_z", "p_x_and_z"):
        assert np.array_equal(getattr(got, field), getattr(want, field))


@pytest.mark.parametrize("kind", ["regular", "regular-sib", "irregular"])
def test_density_evolution_equals_jax(kind, tmp_path):
    """Every table, matching vector, the MI trajectory and every diagnostic."""
    port, jax = build_both(kind)
    assert port.is_irregular == (kind == "irregular")
    assert_same_arrays(saved(port, tmp_path / "port.npz"), saved(jax, tmp_path / "jax.npz"))


@pytest.mark.parametrize("kind", ["regular", "irregular"])
def test_flat_layout_equals_jax_and_round_trips(kind):
    port, jax = build_both(kind)
    t, jt = port.tables, jax.tables
    flat = t.to_flat()
    for got, want in zip(flat, jt.to_flat()):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    match = t.flat_matching() if t.has_matching else (None, None)
    if t.has_matching:
        for got, want in zip(match, jt.flat_matching()):
            assert np.array_equal(got, want)
    dims = (t.cardinality_t_channel, t.cardinality_t_decoder, t.i_max, t.d_c_max, t.d_v_max)
    back = TrellisTables.from_flat(*flat, *dims, *match)
    jback = JaxTables.from_flat(*flat, *dims, *match)
    for name in ("cn_iter0_first", "cn_iter0_rest", "cn_rest", "vn_first", "vn_rest",
                 "matching_cn", "matching_vn"):
        got, orig = getattr(back, name), getattr(t, name)
        if orig is None:
            assert got is None and getattr(jback, name) is None
            continue
        assert np.array_equal(got, orig) and np.array_equal(got, getattr(jback, name)), name


def test_sib_equals_jax():
    from scipy.stats import norm

    y = np.linspace(-3, 3, 128)
    p0 = norm.pdf(y, loc=1, scale=np.sqrt(0.7)) * (y[1] - y[0])
    p = 0.5 * np.stack([p0, p0[::-1]], axis=1)
    p /= p.sum()
    for name in ("SymmetricSIB", "LinSymSIB"):
        got, want = getattr(port_sib, name)(p, 16, 5), getattr(jax_sib, name)(p, 16, 5)
        got.run_IB_algo()
        want.run_IB_algo()
        for g, w in zip(got.get_results(), want.get_results()):
            assert np.array_equal(g, w)
        assert got.get_mutual_inf() == want.get_mutual_inf()
    got = port_sib.sequential_sib(p, 8, nror=5, seed=3)
    want = jax_sib.sequential_sib(p, 8, nror=5, seed=3)
    assert np.array_equal(got.labels, want.labels)
    assert (got.mi_xt, got.mi_xy) == (want.mi_xt, want.mi_xy)


@pytest.mark.parametrize("direction", ["port-to-jax", "jax-to-port"])
def test_save_in_one_package_load_in_the_other(direction, tmp_path):
    port, jax = build_both("irregular")
    path = str(tmp_path / "cfg.npz")
    if direction == "port-to-jax":
        port.save(path)
        loaded, other = JaxConfig.load(path), JaxConfig
    else:
        jax.save(path)
        loaded, other = DecoderConfig.load(path), DecoderConfig
    again = str(tmp_path / "again.npz")
    loaded.save(again)
    assert isinstance(loaded, other) and loaded.is_irregular
    assert_same_arrays(arrays(again), arrays(path))


@pytest.mark.parametrize("name", REBUILT_HERE)
def test_port_rebuilds_the_committed_config(name, tmp_path):
    assert_same_arrays(saved(rebuild_committed_config(name), tmp_path / "x.npz"),
                       arrays(CONFIG_DIR / f"{name}.npz"))


def test_config_module_keeps_the_one_decoder_config():
    assert port_config.DecoderConfig is DecoderConfig


def test_get_or_build_config_builds_once_then_loads(tmp_path, monkeypatch):
    built = []
    real = artifacts.build_decoder_config
    monkeypatch.setattr(artifacts, "build_decoder_config",
                        lambda **kw: built.append(kw) or real(**kw))
    first = artifacts.get_or_build_config("regular-3-6-504", i_max=4, directory=str(tmp_path))
    path = artifacts.config_path(get_model("regular-3-6-504"), 1.5, 4, 16, str(tmp_path))
    second = artifacts.get_or_build_config("regular-3-6-504", i_max=4, directory=str(tmp_path))
    assert len(built) == 1 and list(tmp_path.iterdir()) == [tmp_path / path.split("/")[-1]]
    assert np.array_equal(first.tables.cn_rest, second.tables.cn_rest)
    assert second.design_ebn0_db == 1.5 and second.tables.i_max == 4


def test_cli_construct_writes_the_jax_arrays(tmp_path, capsys):
    argv = ["--model", "regular-3-6-504", "--ebn0", "1.5", "--i-max", "6"]
    port_cli.main(argv + ["--output", str(tmp_path / "port.npz")])
    jax_cli.main(argv + ["--output", str(tmp_path / "jax.npz")])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"saved {tmp_path / 'port.npz'}: design 1.5 dB, |T|=16, i_max=6")
    assert out[0].split(":", 1)[1] == out[1].split(":", 1)[1]
    assert_same_arrays(arrays(tmp_path / "port.npz"), arrays(tmp_path / "jax.npz"))


def test_export_exit_chart_writes_a_png(tmp_path):
    pytest.importorskip("matplotlib")
    port, _ = build_both("regular")
    port.export_exit_chart(str(tmp_path / "exit.png"), label="regular (3,6)")
    assert (tmp_path / "exit.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
