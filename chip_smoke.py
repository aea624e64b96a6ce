"""Smoke run of the PyTorch port on one CUDA card.

Drives the port's main paths through the fused CUDA kernels and checks them:
the headline BER simulation (WLAN 802.11n N=1296, IB decoder |T|=16 with
message alignment, i_max=50, all-zeros chain, batch 4096 x 8 steps) through
K1, and the float decoders' cells (min-sum and BP on 16-level quantized
LLRs, 2.0 dB, i_max 50, the same batch) and the encoded chain through K2.

1. the card exists (else this raises); its name and power limit;
2. K1 builds from ``csrc/ib_lut_fused.cu`` with nvcc (K2 builds beside it);
3. K1 against its plain PyTorch twin on the same CUDA inputs, bit-exact:
   |T|=16 at 0.8 and 6.0 dB with early exit on and off, |T|=32 fixed;
4. the headline simulation: coded Mbit/s, one kernel launch per Monte-Carlo
   step, FER and BER at 0.8 dB inside bands around the JAX package's
   reference curve, mean iterations at 0.8 and 2.4 dB;
5. one decode at batch 4096 by K1 and by the twin, timed;
6. K2 built from ``csrc/float_fused.cu``: build time, registers and spills
   of each rule's kernel;
7. K2 against its plain twin on the same CUDA inputs, both rules, WLAN,
   i_max 50, batch 512 (the last 5-codeword tile padded): quantized LLRs at
   2.0 dB with early exit on and off, at 4.0 dB (tiles exit after different
   bodies), true LLRs at 2.0 dB, and i_max 1. Outputs (``==``, so +0 == -0),
   unsatisfied counts and mean iterations must be equal for min-sum and for
   BP: K2 and torch on the card both take expf/log1pf from CUDA's math
   library;
8. the two float cells: coded Mbit/s and mean iterations, one K2 launch per
   Monte-Carlo step;
9. the encoded chain against the JAX package's reference curves, 32768
   blocks each: min-sum at 1.6 dB, BP at 1.2 dB, IB (K1) at 0.8 dB; FER and
   BER inside bands of about 3 sigma of both samples;
10. one decode at batch 4096 per rule by K2 and by the plain whole-batch
    decoder, early exit off (the two compute the same result), timed.

Each phase prints one line per check; any failure raises and exits
non-zero. The last lines are the kernels' JSON record, the card's name and
power limit, and the device record.

Usage: python3 chip_smoke.py
"""

from __future__ import annotations

import json
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import torch


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
        timeout=60,
    ).stdout.strip()


def ptxas_lines(log: str, names: dict[str, str] | None = None) -> str:
    """Registers and spills of each kernel in an ``nvcc -Xptxas -v`` log,
    labelled by ``names`` (a substring of the mangled name -> label)."""
    out, label = [], ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            label = next((v for k, v in (names or {}).items() if k in line), "")
        elif "registers" in line or "spill" in line:
            out.append(f"{label + ': ' if label else ''}{line.strip()}")
    return "; ".join(out)


def cuda_ms(fn, reps: int = 10) -> float:
    """Mean milliseconds of ``fn()`` on the card over ``reps`` calls after
    one warm-up call, by CUDA events."""
    fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


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
        sample_llrs_from_uniform,
        sigma2_from_ebn0_db,
    )
    from informationbottleneckdecodingldpc_torch.construct import DecoderConfig
    from informationbottleneckdecodingldpc_torch.decode import (
        DeviceTrellis,
        belief_propagation_decode,
        min_sum_decode,
    )
    from informationbottleneckdecodingldpc_torch.encode import LDPCEncoder
    from informationbottleneckdecodingldpc_torch.kernels import (
        FusedFloatDecoder,
        FusedIBDecoder,
        float_decode_tiled,
        ib_lut_decode_tiled,
    )
    from informationbottleneckdecodingldpc_torch.kernels._build import load_library
    from informationbottleneckdecodingldpc_torch.models import get_model
    from informationbottleneckdecodingldpc_torch.sim import BERSimulator
    from informationbottleneckdecodingldpc_torch.sim.engine import received_plane
    from informationbottleneckdecodingldpc_torch.utils.benchmarks import (
        CONFIG_DIR,
        FLOAT_SCENARIOS,
        build_float_sim,
        build_headline_sim,
        measure_sim_throughput,
    )

    dev = torch.device("cuda")

    # -- 2: build (both kernels' nvcc runs start together) ----------------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        builds = {n: pool.submit(load_library, n) for n in ("ib_lut_fused", "float_fused")}
        _, build = builds["ib_lut_fused"].result()
        k1_loaded = time.perf_counter() - t0
        _, k2_build = builds["float_fused"].result()
        k2_loaded = time.perf_counter() - t0
    print(f"[2 build] ib_lut_fused.cu: nvcc {build['seconds']:.2f} s, load "
          f"{k1_loaded:.2f} s; {ptxas_lines(build['log'])}", flush=True)

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

    # -- 6: K2 build ------------------------------------------------------
    print(f"[6 build] float_fused.cu: nvcc {k2_build['seconds']:.2f} s (beside "
          f"K1), both loaded after {k2_loaded:.2f} s; "
          f"{ptxas_lines(k2_build['log'], {'ILi0E': 'minsum', 'ILi1E': 'bp'})}",
          flush=True)

    # -- 7: K2 vs plain twin ---------------------------------------------
    rules = ("minsum", "bp")
    k2_err = dict.fromkeys(rules, 0.0)

    def float_llrs(ebn0_db: float, batch: int, seed: int, true: bool = False):
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        shape = (layout.n_vars, batch)
        sigma2 = float(sigma2_from_ebn0_db(ebn0_db, layout.code_rate))
        if true:
            noise = torch.randn(shape, generator=g, device=dev)
            zeros = torch.zeros(shape, dtype=torch.int8, device=dev)
            return 2.0 * received_plane(zeros, noise, sigma2) / sigma2
        qt = device_tables(build_quantizer_tables(sigma2, 3.0, 16, 2000), dev)
        u = torch.rand(shape, generator=g, device=dev)
        return sample_llrs_from_uniform(
            qt.cdf, qt.llrs, u, torch.zeros(shape, dtype=torch.int32, device=dev)
        )

    def same(got, ref) -> bool:
        return (
            bool((got.outputs == ref.outputs).all())
            and torch.equal(got.unsatisfied, ref.unsatisfied)
            and float(got.iterations) == float(ref.iterations)
        )

    float_cases = [  # (label, Eb/N0, true LLRs, max_iters, early exit)
        ("quantized", 2.0, False, 50, True),
        ("quantized", 2.0, False, 50, False),
        ("quantized", 4.0, False, 50, True),
        ("true", 2.0, True, 50, True),
        ("quantized", 2.0, False, 1, True),
    ]
    for rule in rules:
        for k, (label, ebn0, true, imax, early_exit) in enumerate(float_cases):
            ch = float_llrs(ebn0, 512, seed=100 + k, true=true)
            dec = FusedFloatDecoder(layout, rule, max_iters=imax, early_exit=early_exit)
            got = dec(ch)
            ref = float_decode_tiled(
                layout, ch, rule, dec.batch_tile, imax, early_exit=early_exit
            )
            torch.cuda.synchronize()
            err = float((got.outputs - ref.outputs).abs().max())
            k2_err[rule] = max(k2_err[rule], err)
            if not same(got, ref):
                raise AssertionError(
                    f"K2 {rule} disagrees with its twin on {label} LLRs at {ebn0} "
                    f"dB, max_iters {imax}, early_exit={early_exit}: max |out diff| "
                    f"{err}, iterations {float(got.iterations)} vs "
                    f"{float(ref.iterations)}"
                )
            print(f"[7 exact] K2 {rule} {label} LLRs {ebn0} dB max_iters {imax} "
                  f"early_exit={early_exit} batch 512 tile {dec.batch_tile}: outputs, "
                  f"unsatisfied and mean iterations {float(got.iterations):.4f} equal",
                  flush=True)

    # -- 8: the float cells ------------------------------------------------
    k2_launches = {}
    for name in FLOAT_SCENARIOS:
        sc = FLOAT_SCENARIOS[name]
        sim = build_float_sim(name, dev)
        decoder = sim.fused_decoder
        decoder.launches = 0
        rate = measure_sim_throughput(sim, sc["ebn0_db"])
        timed_steps = (1 + 6) * sim.steps_per_dispatch
        point = sim.run_point(sc["ebn0_db"], min_errors=10**12, max_blocks=32768)
        k2_launches[sc["decoder"]] = decoder.launches
        steps = timed_steps + point.blocks // sim.batch_total
        if decoder.launches != steps:
            raise AssertionError(f"{decoder.launches} K2 launches for {steps} steps")
        print(f"[8 cell] {name}: {rate / 1e6:.2f} Mbit/s coded on {card}; "
              f"{decoder.launches} K2 launches for {steps} steps; "
              f"{sc['ebn0_db']} dB over {point.blocks} blocks: FER {point.fer:.5f}, "
              f"BER {point.ber:.3e}, mean iterations {point.mean_iterations:.3f}",
              flush=True)

    # -- 9: encoded chain vs the reference curves --------------------------
    H = get_model("wlan-1296").make_h()
    encoder = LDPCEncoder(H)
    ib_tables = configs["wlan_T16_0.8"].tables
    bands = [  # (decoder, Eb/N0, FER, FER band, BER, reference file)
        ("minsum", 1.6, 0.2791, 0.025, 0.03329, "wlan_minsum_enc"),
        ("bp", 1.2, 0.1267, 0.018, 0.008859, "wlan_bp_enc"),
        ("ib", 0.8, 0.666, 0.07, 0.0745, "wlan_ib_T16_enc"),
    ]
    for decoder_name, ebn0, fer_ref, fer_band, ber_ref, ref_name in bands:
        kw = dict(max_iters=50)
        if decoder_name == "ib":
            kw = dict(
                trellis=DeviceTrellis.from_tables(ib_tables, dev),
                cardinality_t_channel=ib_tables.cardinality_t_channel,
            )
        sim = BERSimulator(
            layout, decoder_name, device=dev, chain="encoded", encoder=encoder,
            batch_per_device=4096, steps_per_dispatch=8, seed=0, **kw,
        )
        point = sim.run_point(ebn0, min_errors=10**12, max_blocks=32768)
        ok = abs(point.fer - fer_ref) <= fer_band and abs(point.ber - ber_ref) <= 0.15 * ber_ref
        print(f"[9 encoded] {decoder_name} {ebn0} dB: {point.blocks} blocks, FER "
              f"{point.fer:.4f} ({fer_ref} +- {fer_band}), BER {point.ber:.5f} "
              f"({ber_ref} +- 15%, results/ber/{ref_name}.json), mean iterations "
              f"{point.mean_iterations:.3f}", flush=True)
        if not ok:
            raise AssertionError(f"encoded {decoder_name} FER or BER outside its band")

    # -- 10: one decode at batch 4096, K2 and the plain decoder ------------
    k2_ms, k2_plain_ms = {}, {}
    ch = float_llrs(2.0, 4096, seed=99)
    plain = {"minsum": min_sum_decode, "bp": belief_propagation_decode}
    for rule in rules:
        dec = FusedFloatDecoder(layout, rule, max_iters=50, early_exit=False)
        k2_ms[rule] = cuda_ms(lambda: dec(ch))
        got = dec(ch)
        plain[rule](layout, ch, 50, early_exit=False)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = plain[rule](layout, ch, 50, early_exit=False)
        torch.cuda.synchronize()
        k2_plain_ms[rule] = (time.perf_counter() - t0) * 1e3
        err = float((got.outputs - ref.outputs).abs().max())
        k2_err[rule] = max(k2_err[rule], err)
        if not same(got, ref):
            raise AssertionError(f"K2 {rule} disagrees with the plain decoder ({err})")
        print(f"[10 times] batch 4096 {rule} decode, 49 bodies: K2 {k2_ms[rule]:.3f} "
              f"ms (tile {dec.batch_tile}), plain whole-batch decoder "
              f"{k2_plain_ms[rule]:.1f} ms on {card}; outputs equal", flush=True)

    k2_source = "informationbottleneckdecodingldpc_torch/csrc/float_fused.cu"
    k2_replaces = "informationbottleneckdecodingldpc_tpu/kernels/float_fused.py:143"
    print(json.dumps({"kernels": [{
        "name": "ib_lut_fused",
        "route": "cuda",
        "source": "informationbottleneckdecodingldpc_torch/csrc/ib_lut_fused.cu",
        "replaces": "informationbottleneckdecodingldpc_tpu/kernels/ib_lut_fused.py:293",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }] + [{
        "name": f"float_fused_{rule}",
        "route": "cuda",
        "source": k2_source,
        "replaces": k2_replaces,
        "launches": k2_launches[rule],
        "max_abs_err": k2_err[rule],
        "ms": k2_ms[rule],
        "plain_ms": k2_plain_ms[rule],
    } for rule in rules]}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
