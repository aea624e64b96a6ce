"""Smoke run of the PyTorch port on one CUDA card.

Drives the port's main path, the headline BER simulation (WLAN 802.11n
N=1296, IB decoder |T|=16 with message alignment, i_max=50, all-zeros chain,
batch 4096 x 8 steps), through the fused CUDA kernel K1, and checks it:

1. the card exists (else this raises); its name and power limit;
2. K1 builds from ``csrc/ib_lut_fused.cu`` with nvcc;
3. K1 against its plain PyTorch twin on the same CUDA inputs, bit-exact:
   |T|=16 at 0.8 and 6.0 dB with early exit on and off, |T|=32 fixed;
4. the headline simulation: coded Mbit/s, one kernel launch per Monte-Carlo
   step, FER and BER at 0.8 dB inside bands around the JAX package's
   reference curve, mean iterations at 0.8 and 2.4 dB;
5. one decode at batch 4096 by K1 and by the twin, timed.

Each phase prints one line; any failure raises and exits non-zero. The last
two lines are the kernels' JSON record and the device record.

Usage: python3 chip_smoke.py
"""

from __future__ import annotations

import json
import subprocess
import time

import torch


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
        timeout=60,
    ).stdout.strip()


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device; none is available")
    card = nvidia_smi()
    print(f"[1 device] {card}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)

    from informationbottleneckdecodingldpc_torch.channel import (
        build_quantizer_tables,
        device_tables,
        sample_clusters_from_uniform,
        sigma2_from_ebn0_db,
    )
    from informationbottleneckdecodingldpc_torch.construct import DecoderConfig
    from informationbottleneckdecodingldpc_torch.kernels import (
        FusedIBDecoder,
        ib_lut_decode_tiled,
    )
    from informationbottleneckdecodingldpc_torch.kernels._build import load_library
    from informationbottleneckdecodingldpc_torch.models import get_model
    from informationbottleneckdecodingldpc_torch.utils.benchmarks import (
        CONFIG_DIR,
        build_headline_sim,
        measure_sim_throughput,
    )

    dev = torch.device("cuda")

    # -- 2: build --------------------------------------------------------
    t0 = time.perf_counter()
    _, build = load_library("ib_lut_fused")
    ptxas = [l.strip() for l in build["log"].splitlines() if "registers" in l]
    print(f"[2 build] ib_lut_fused.cu: nvcc {build['seconds']:.2f} s, load "
          f"{time.perf_counter() - t0:.2f} s; {'; '.join(ptxas)}", flush=True)

    # -- 3: kernel vs plain twin -----------------------------------------
    layout = get_model("wlan-1296").make_layout()
    configs = {
        name: DecoderConfig.load(str(CONFIG_DIR / f"{name}.npz"))
        for name in ("wlan_T16_0.8", "wlan_T32_0.6")
    }

    def clusters(cfg, ebn0_db: float, batch: int, seed: int) -> torch.Tensor:
        tch = cfg.tables.cardinality_t_channel
        qt = device_tables(
            build_quantizer_tables(
                sigma2_from_ebn0_db(ebn0_db, layout.code_rate), 3.0, tch, 2000
            ),
            dev,
        )
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        u = torch.rand((layout.n_vars, batch), generator=g, device=dev)
        return sample_clusters_from_uniform(qt.cdf, u, torch.zeros_like(u, dtype=torch.int32))

    max_abs_err = 0
    cases = [
        ("wlan_T16_0.8", 0.8, True),
        ("wlan_T16_0.8", 0.8, False),
        ("wlan_T16_0.8", 6.0, True),
        ("wlan_T16_0.8", 6.0, False),
        ("wlan_T32_0.6", 0.8, False),
    ]
    for k, (name, ebn0, early_exit) in enumerate(cases):
        cfg = configs[name]
        ch = clusters(cfg, ebn0, 512, seed=k)
        dec = FusedIBDecoder(layout, cfg.tables, early_exit=early_exit)
        got = dec(ch)
        ref = ib_lut_decode_tiled(
            layout, dec.trellis(dev), ch, dec.batch_tile, early_exit=early_exit
        )
        torch.cuda.synchronize()
        err = int((got.outputs - ref.outputs).abs().max())
        max_abs_err = max(max_abs_err, err)
        if not (
            torch.equal(got.outputs, ref.outputs)
            and torch.equal(got.unsatisfied, ref.unsatisfied)
            and float(got.iterations) == float(ref.iterations)
        ):
            raise AssertionError(
                f"K1 disagrees with its twin on {name} {ebn0} dB early_exit="
                f"{early_exit}: max |out diff| {err}, iterations "
                f"{float(got.iterations)} vs {float(ref.iterations)}"
            )
        if early_exit and ebn0 == 6.0 and float(got.iterations) >= 49.0:
            raise AssertionError("early exit did not fire at 6.0 dB")
        print(f"[3 exact] {name} {ebn0} dB early_exit={early_exit} batch 512 "
              f"tile {dec.batch_tile}: outputs, unsatisfied and mean iterations "
              f"{float(got.iterations):.4f} equal", flush=True)

    # -- 4: headline main path -------------------------------------------
    sim = build_headline_sim(dev)
    decoder = sim.fused_decoder
    decoder.launches = 0
    rate = measure_sim_throughput(sim, 0.8)
    timed_steps = (1 + 6) * sim.steps_per_dispatch
    point = sim.run_point(0.8, min_errors=10**12, max_blocks=8192)
    high = sim.run_point(2.4, min_errors=10**12, max_blocks=8192)
    launches = decoder.launches
    steps = timed_steps + (point.blocks + high.blocks) // sim.batch_total
    if launches != steps:
        raise AssertionError(f"{launches} K1 launches for {steps} steps")
    print(f"[4 headline] {rate / 1e6:.2f} Mbit/s coded on {card}; "
          f"{launches} K1 launches for {steps} steps", flush=True)
    fer_ok = abs(point.fer - 0.666) <= 0.07
    ber_ok = abs(point.ber - 0.0745) <= 0.15 * 0.0745
    print(f"[4 point] 0.8 dB: {point.blocks} blocks, FER {point.fer:.4f} "
          f"(0.666 +- 0.07), BER {point.ber:.5f} (0.0745 +- 15%), mean "
          f"iterations {point.mean_iterations:.3f}; 2.4 dB: FER {high.fer:.5f}, "
          f"BER {high.ber:.3e}, mean iterations {high.mean_iterations:.3f}",
          flush=True)
    if not (fer_ok and ber_ok):
        raise AssertionError("FER or BER at 0.8 dB outside its band")

    # -- 5: one decode at batch 4096, K1 and twin --------------------------
    cfg = configs["wlan_T16_0.8"]
    ch = clusters(cfg, 0.8, 4096, seed=99)
    dec = FusedIBDecoder(layout, cfg.tables)
    dec(ch)  # warm-up
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    reps = 10
    start.record()
    for _ in range(reps):
        got = dec(ch)
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop) / reps
    t0 = time.perf_counter()
    ref = ib_lut_decode_tiled(layout, dec.trellis(dev), ch, dec.batch_tile)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = int((got.outputs - ref.outputs).abs().max())
    max_abs_err = max(max_abs_err, err)
    if err or not torch.equal(got.unsatisfied, ref.unsatisfied):
        raise AssertionError(f"K1 disagrees with its twin at batch 4096 ({err})")
    print(f"[5 times] batch 4096 decode: K1 {ms:.3f} ms, plain twin "
          f"{plain_ms:.1f} ms on {card}", flush=True)

    print(json.dumps({"kernels": [{
        "name": "ib_lut_fused",
        "route": "cuda",
        "source": "informationbottleneckdecodingldpc_torch/csrc/ib_lut_fused.cu",
        "replaces": "informationbottleneckdecodingldpc_tpu/kernels/ib_lut_fused.py:293",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
