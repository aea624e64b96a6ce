"""The reference's frozen arithmetic against the port's plain versions:
Philox keys and planes, the quantizer's tables, the parity-check matrices,
the encoder, and the decode against the port's CPU twins (K1's on WLAN,
K3's on DVB-S2) at a small batch."""

import numpy as np
import pytest
import torch

from informationbottleneckdecodingldpc_torch.channel.quantizer import build_quantizer_tables
from informationbottleneckdecodingldpc_torch.construct import DecoderConfig
from informationbottleneckdecodingldpc_torch.decode import DeviceTrellis
from informationbottleneckdecodingldpc_torch.encode import LDPCEncoder
from informationbottleneckdecodingldpc_torch.encode.encoder import device_encoder
from informationbottleneckdecodingldpc_torch.kernels.ib_lut_fused import ib_lut_decode_tiled
from informationbottleneckdecodingldpc_torch.models import get_model
from informationbottleneckdecodingldpc_torch.sim import rng
from informationbottleneckdecodingldpc_torch.sim.engine import step_seed
from ldpc_bench.harness import spec
from ldpc_bench.reference import chain, code, philox, quantizer

CONFIGS = ["wlan1296-ib-t16", "dvbs2-64800-ib-t16"]


@pytest.mark.parametrize("seed,ebn0,step", [(0, 0.8, 0), (2**31 + 5, 1.1, 77), (2**62 + 3, 2.4, 2**40)])
def test_step_key_equals_the_engine(seed, ebn0, step):
    assert philox.step_key(seed, ebn0, step) == rng.key_words(step_seed(seed, ebn0, step))


@pytest.mark.parametrize("kind", ["uniform", "normal", "bits"])
@pytest.mark.parametrize("rows,offset,batch", [(1296, 0, 8), (7, 5, 3), (130, 2**32 - 4, 4)])
def test_planes_equal_the_plain_planes(kind, rows, offset, batch):
    key = philox.step_key(123, 0.8, 9)
    assert torch.equal(philox.plane(kind, key, rows, offset, batch, "cpu"),
                       rng.plane_plain(kind, key, rows, offset, batch))


@pytest.mark.parametrize("ebn0,rate", [(0.8, 0.5), (1.1, 0.4999999999999999), (2.4, 0.5)])
def test_quantizer_tables_equal_the_port(ebn0, rate):
    sigma2 = quantizer.sigma2_from_ebn0_db(ebn0, rate)
    limits, cdf, llrs = quantizer.tables(sigma2, 3.0, 16, 2000)
    port = build_quantizer_tables(sigma2, 3.0, 16, 2000)
    assert np.array_equal(limits, port.limits.astype(np.float32))
    assert np.array_equal(cdf, port.cdf_t_given_x0.astype(np.float32))
    assert np.array_equal(llrs, port.output_llrs.astype(np.float32))


@pytest.mark.parametrize("name", CONFIGS)
def test_code_and_encoder_equal_the_port(name):
    config = spec.config(name)
    H = code.parity_check(config["code"])
    spec_ = get_model(config["program"]["model"])
    assert (H != spec_.make_h()).nnz == 0
    ref = chain.ReferenceChain(config, str(spec.config_file(config["decoder"]["tables"])), H, "cpu")
    assert ref.rate == spec_.make_layout(H).code_rate
    info = philox.plane("bits", philox.step_key(5, 1.1, 3), ref.k, 0, 3, "cpu")
    assert torch.equal(ref.encoder()(info), device_encoder(LDPCEncoder(H), "cpu")(info))


@pytest.mark.parametrize("name,cell,batch,tile", [
    ("wlan1296-ib-t16", "wlan_ib.queue_enc512", 32, 16),
    ("dvbs2-64800-ib-t16", "dvbs2_ib.enc_b1024", 2, 2),
])
def test_steps_equal_the_port_twin(name, cell, batch, tile):
    config = spec.config(name)
    workload = spec.workload(cell)
    H = code.parity_check(config["code"])
    tables_path = str(spec.config_file(config["decoder"]["tables"]))
    ref = chain.ReferenceChain(config, tables_path, H, "cpu")
    layout = get_model(config["program"]["model"]).make_layout(H)
    trellis = DeviceTrellis.from_tables(DecoderConfig.load(tables_path).tables, "cpu")
    for chain_kind in ("allzero", "encoded"):
        r = ref.steps(9, workload["ebn0_db"], [4], batch, chain_kind, tile)[0]
        port = ib_lut_decode_tiled(layout, trellis, r["input"], tile)
        assert torch.equal(r["hard"], port.outputs < 8)
        assert np.float32(float(port.iterations)) == r["mean_bodies"]
