"""The frozen bound arithmetic equals the port's ``decode_bound`` today, for
both configurations (IB) and the min-sum row, and the metric readers'
arithmetic on a hand-built trace."""

import numpy as np
import pytest

from informationbottleneckdecodingldpc_torch.construct import DecoderConfig
from informationbottleneckdecodingldpc_torch.models import get_model
from informationbottleneckdecodingldpc_torch.utils.roofline import decode_bound
from ldpc_bench import run
from ldpc_bench.harness import roofline, spec
from ldpc_bench.harness.trace import Event, Trace
from ldpc_bench.reference import code

CONFIGS = ["wlan1296-ib-t16", "dvbs2-64800-ib-t16"]


def _setup(name):
    config = spec.config(name)
    H = code.parity_check(config["code"])
    tables_path = spec.config_file(config["decoder"]["tables"])
    layout = get_model(config["program"]["model"]).make_layout(H)
    return config, H, tables_path, layout


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("batch,bodies", [(4096, 49.0), (128, 17.25)])
def test_ib_bound_equals_the_port(name, batch, bodies):
    config, H, tables_path, layout = _setup(name)
    port = decode_bound(layout, "ib", batch, bodies, DecoderConfig.load(str(tables_path)).tables)
    g = run.graph_summary(H, config, tables_path)
    ops = roofline.decode_ops("ib", g["check_degrees"], g["var_degrees"], batch, bodies, g["alignment"])
    moved = roofline.decode_bytes(g["n_vars"], batch, g["table_elements"])
    assert moved == port["bytes"]
    assert ops["lookup"] == port["ops"]["lookup"]
    assert roofline.bound_ms(moved, ops)["bound_ms"] == pytest.approx(port["bound_ms"], rel=1e-12)


@pytest.mark.parametrize("name", CONFIGS)
def test_minsum_bound_equals_the_port(name):
    config, H, _, layout = _setup(name)
    port = decode_bound(layout, "minsum", 1024, 26.0)
    g = run.graph_summary(H, config, spec.config_file(config["decoder"]["tables"]))
    ops = roofline.decode_ops("minsum", g["check_degrees"], g["var_degrees"], 1024, 26.0)
    moved = roofline.decode_bytes(g["n_vars"], 1024, 0)
    assert moved == port["bytes"]
    for k in ("compare", "fp32"):
        assert ops[k] == port["ops"][k]
    assert roofline.bound_ms(moved, ops)["bound_ms"] == pytest.approx(port["bound_ms"], rel=1e-12)


def _trace(device, steps=2, batch=4096, bodies=49.0, cell="wlan_ib.allzero_b4096"):
    workload = spec.workload(cell)
    config = workload["config_spec"]
    H = code.parity_check(config["code"])
    readers = {m: spec.metric(m) for m in spec.names("metrics")}
    host = [Event("ldpc_bench.traced_window", 0.0, 100.0), Event("aten::item", 60.0, 80.0)]
    return Trace(device, host, 0.0, 100.0, steps=steps, batch=batch, mean_bodies=bodies, cell=workload,
                 graph=run.graph_summary(H, config, spec.config_file(config["decoder"]["tables"])),
                 readers=readers)


def test_idle_share_and_per_step_arithmetic():
    device = [
        Event("void channel_input_kernel<3>(Args)", 0.0, 2.0),
        Event("void ib_lut_fused_kernel<4>(Params)", 2.0, 30.0),
        Event("reduce_kernel", 31.0, 33.0),
        Event("void channel_input_kernel<3>(Args)", 40.0, 41.0),
        Event("elementwise_kernel", 40.5, 43.0),
        Event("void ib_lut_fused_kernel<4>(Params)", 43.0, 58.0),
        Event("void hbm_tiles::exit_kernel<(anonymous namespace)::Params>(Params, int)", 58.0, 60.0),
        Event("Memcpy DtoH", 90.0, 95.0),
    ]
    t = _trace(device)
    # busy: [0, 30] + [31, 33] + [40, 60] + [90, 95] = 57 us of 100
    assert t.value("device.idle_share") == pytest.approx(43.0)
    assert t.value("decode.ms_per_step") == pytest.approx((28.0 + 17.0) / 1e3 / 2)
    # channel input: step 1 the Philox launch, step 2 it and the encoder-like kernel
    assert t.value("channel_input.ms_per_step") == pytest.approx((2.0 + 1.0 + 2.5) / 1e3 / 2)
    bound = roofline.bound_ms(roofline.decode_bytes(1296, 4096, t.graph["table_elements"]),
                              roofline.decode_ops("ib", t.graph["check_degrees"], t.graph["var_degrees"],
                                                  4096, 49.0))["bound_ms"]
    assert t.value("decode.roofline_share") == pytest.approx(100 * bound / t.value("decode.ms_per_step"))


def test_nothing_to_read_is_left_out():
    t = _trace([Event("elementwise_kernel", 0.0, 5.0)])
    assert t.value("decode.ms_per_step") is None
    assert t.value("decode.roofline_share") is None
    assert t.value("channel_input.ms_per_step") is None
    assert t.value("device.idle_share") == pytest.approx(95.0)


def test_breakdown_names_the_host_call_of_each_gap():
    from ldpc_bench.harness.trace import breakdown

    device = [Event("k1", 0.0, 50.0), Event("k2", 90.0, 100.0), Event("k1", 55.0, 60.0)]
    host = [Event("ldpc_bench.traced_window", 0.0, 100.0), Event("aten::item", 60.0, 90.0)]
    out = breakdown(device, host, 0.0, 100.0)
    assert out["device_ops"][0] == ["k1", pytest.approx(55e-6)]
    assert out["idle_gaps"][0] == ["aten::item", pytest.approx(30e-6)]
    assert np.isclose(sum(s for _, s in out["idle_gaps"]), 35e-6)
