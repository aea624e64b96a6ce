"""Time the decode kernels K1, K2, K3 and K4 and the copy K6 on one CUDA card.

Each time is the mean of ``--reps`` calls after a warm-up, by CUDA events,
on the inputs of ``chip_smoke.py``'s timing phases (channel draws from
``torch.Generator`` seed 99, 16-level quantized LLRs or clusters, i_max 50,
default tiles):

- K1 (phase 5): WLAN N=1296 IB |T|=16 (``wlan_T16_0.8``) at batch 4096 and
  0.8 dB, early exit off and on, and at 2.4 dB with early exit on; WLAN
  |T|=32 (``wlan_T32_0.6``) at batch 2048 and 0.6 dB; regular (3,6) N=8000
  (``regular_T16_1.05``, i_max 250, tile 4) at batch 512 and 1.05 dB;
- K2 (phase 10): WLAN N=1296 at batch 4096 and 2.0 dB, min-sum and BP, early
  exit off (49 bodies) and on; regular (3,6) N=8000 min-sum at batch 1024 and
  2.0 dB (one codeword per CTA), early exit off and on;
- K3 and K4 (phase 15): DVB-S2 R=1/2 N=64800 at batch 1024 and 1.0 dB; K3 (IB
  |T|=16 designed at 0.6 dB, early exit off), K4 min-sum with early exit off
  and on (no tile leaves at 1.0 dB, so both run 49 bodies) and K4 BP with
  early exit off;
- K6 (phase 17): one 256 MB pass, and ``copy_`` of the same buffers.

With ``--reads`` it times the read probes P2/P3 instead (phase 23's source,
seed 23): every variant and chunk size on one block per SM and, but nested,
on two, each first held equal to its plain checksums, as a pass's device ms
(its bytes over the rate differenced over passes in one launch) and as the
mean of ``--reps`` one-pass calls. With ``--columns`` it times P1's four
rows (CUDA cores and tensor cores at T1 16 and 32, phase 22's inputs, seed
17, over the elements that fill the card), each first held equal to its
plain version over 16 steps, as the device ms of a 16-step launch (its
elements times 16 over the element-step rate differenced over steps in one
launch) and as the mean of ``--reps`` 16-step launches.

The package is imported from the checkout ``--tree`` (default: the one this
file is in), put first on ``sys.path``, and only entry points that the
package has had since its benchmark matrix (P1-P3: since its probes) are
used, so two checkouts can be timed one after the other in one run on one
card:

  python3 informationbottleneckdecodingldpc_torch/cli/kernel_times.py \\
      [--tree build/parent] [--out PATH] [--reps 5] [--reads | --columns]

Prints and writes one JSON object: ms per kernel and setting, the mean
iterations of each decode (with ``--reads``: ms per pass and per call of
each read variant; with ``--columns``: ms per 16-step launch of each P1
row) and the card's name and power limit. Without a
CUDA device it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

TREE = Path(__file__).resolve().parents[2]
SEED = 99
COPY_BYTES = 256 * 1024 * 1024  # K6's buffer (utils/roofline.py)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` calls after a warm-up."""
    fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def run(reps: int) -> dict:
    """The times, with the package of the checkout first on ``sys.path``."""
    from informationbottleneckdecodingldpc_torch.channel import (
        build_quantizer_tables,
        device_tables,
        sample_clusters_from_uniform,
        sample_llrs_from_uniform,
        sigma2_from_ebn0_db,
    )
    from informationbottleneckdecodingldpc_torch.construct import DecoderConfig
    from informationbottleneckdecodingldpc_torch.kernels import (
        FusedFloatDecoder,
        FusedIBDecoder,
        HBMFloatDecoder,
        HBMFusedIBDecoder,
        hbm_copy,
    )
    from informationbottleneckdecodingldpc_torch.models import get_model
    from informationbottleneckdecodingldpc_torch.utils.benchmarks import CONFIG_DIR

    dev = torch.device("cuda")

    def inputs(layout, ebn0_db: float, batch: int, levels: int, clusters: bool = False):
        """Quantized LLRs (or cluster indices) of an all-zeros codeword batch."""
        sigma2 = float(sigma2_from_ebn0_db(ebn0_db, layout.code_rate))
        shape = (layout.n_vars, batch)
        g = torch.Generator(device=dev)
        g.manual_seed(SEED)
        u = torch.rand(shape, generator=g, device=dev)
        zeros = torch.zeros(shape, dtype=torch.int32, device=dev)
        qt = device_tables(build_quantizer_tables(sigma2, 3.0, levels, 2000), dev)
        if clusters:
            return sample_clusters_from_uniform(qt.cdf, u, zeros)
        return sample_llrs_from_uniform(qt.cdf, qt.llrs, u, zeros)

    wlan = get_model("wlan-1296").make_layout()
    regular = get_model("regular-3-6-8000").make_layout()
    dvbs2 = get_model("dvbs2-64800").make_layout()
    tables = DecoderConfig.load(str(CONFIG_DIR / "dvbs2_T16_0.6.npz")).tables
    wlan_llrs = inputs(wlan, 2.0, 4096, 16)
    regular_llrs = inputs(regular, 2.0, 1024, 16)
    dv_llrs = inputs(dvbs2, 1.0, 1024, 16)
    dv_clusters = inputs(dvbs2, 1.0, 1024, tables.cardinality_t_channel, clusters=True)
    decoders = {}
    ib = {n: DecoderConfig.load(str(CONFIG_DIR / f"{n}.npz")).tables
          for n in ("wlan_T16_0.8", "wlan_T32_0.6", "regular_T16_1.05")}
    for name, lay, cfg, db, batch, early_exit in (
        ("k1", wlan, "wlan_T16_0.8", 0.8, 4096, False),
        ("k1_early_exit", wlan, "wlan_T16_0.8", 0.8, 4096, True),
        ("k1_2.4dB_early_exit", wlan, "wlan_T16_0.8", 2.4, 4096, True),
        ("k1_t32", wlan, "wlan_T32_0.6", 0.6, 2048, True),
        ("k1_regular", regular, "regular_T16_1.05", 1.05, 512, True),
    ):
        t = ib[cfg]
        decoders[name] = (
            FusedIBDecoder(lay, t, early_exit=early_exit),
            inputs(lay, db, batch, t.cardinality_t_channel, clusters=True),
        )
    for rule in ("minsum", "bp"):
        for early_exit, tag in ((False, ""), (True, "_early_exit")):
            decoders[f"k2_{rule}{tag}"] = (
                FusedFloatDecoder(wlan, rule, max_iters=50, early_exit=early_exit), wlan_llrs
            )
    for early_exit, tag in ((False, ""), (True, "_early_exit")):
        decoders[f"k2_regular_minsum{tag}"] = (
            FusedFloatDecoder(regular, "minsum", max_iters=50, early_exit=early_exit),
            regular_llrs,
        )
    decoders.update({
        "k3": (HBMFusedIBDecoder(dvbs2, tables, early_exit=False), dv_clusters),
        "k4_minsum": (HBMFloatDecoder(dvbs2, "minsum", max_iters=50, early_exit=False), dv_llrs),
        "k4_minsum_early_exit": (HBMFloatDecoder(dvbs2, "minsum", max_iters=50), dv_llrs),
        "k4_bp": (HBMFloatDecoder(dvbs2, "bp", max_iters=50, early_exit=False), dv_llrs),
    })
    ms, iterations = {}, {}
    for name, (dec, x) in decoders.items():
        ms[name] = cuda_ms(lambda: dec(x), reps)
        iterations[name] = float(dec(x).iterations)
        print(f"{name}: {ms[name]:.4f} ms, mean iterations {iterations[name]:.3f}", flush=True)
    src = torch.arange(COPY_BYTES // 4, dtype=torch.int32, device=dev)
    dst = torch.empty_like(src)
    for name, fn in (("k6", lambda: hbm_copy.copy(src, dst)), ("copy_", lambda: dst.copy_(src))):
        ms[name] = cuda_ms(fn, reps)
        if not torch.equal(dst, src):
            raise AssertionError(f"{name} did not copy the buffer")
        print(f"{name}: {ms[name]:.4f} ms per 256 MB pass", flush=True)
    return {"reps": reps, "ms": ms, "mean_iterations": iterations}


def read_times(reps: int) -> dict:
    """P2/P3's ms per pass and per one-pass call, by variant and blocks per
    SM (``<name>_x1``, ``<name>_x2``)."""
    from informationbottleneckdecodingldpc_torch.kernels import bulk_read as p23
    from informationbottleneckdecodingldpc_torch.utils.peaks import differenced_rate
    from informationbottleneckdecodingldpc_torch.utils.probes import read_source

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    src = read_source(dev, seed=23)
    ms, event_ms = {}, {}
    for variant, kb in dict.fromkeys(v for p in ("p2", "p3") for v in p23.PROBES[p]):
        probe = p23.BulkRead(variant, kb * 1024 // p23.ROW_BYTES)
        for per_sm in (1,) if variant == "nested" else (1, 2):
            name, blocks = f"{probe.name}_x{per_sm}", per_sm * sms
            if not torch.equal(probe(src, blocks=blocks), probe.plain(src, blocks)):
                raise AssertionError(f"{name} disagrees with its plain checksums")
            rate = differenced_rate(lambda n: probe(src, passes=n, blocks=blocks),
                                    probe.bytes_per_pass, loops=1, min_seconds=0.1)
            ms[name] = probe.bytes_per_pass / rate * 1e3
            event_ms[name] = cuda_ms(lambda: probe(src, blocks=blocks), reps)
            print(f"{name}: {ms[name]:.4f} ms a pass (differenced), {event_ms[name]:.4f} ms a "
                  "call (events)", flush=True)
    return {"reps": reps, "read_ms_per_pass": ms, "read_event_ms": event_ms}


def column_times(reps: int) -> dict:
    """P1's ms per 16-step launch, differenced and by events, by row
    (``<variant>_T<t1>``), with the elements of each launch."""
    from informationbottleneckdecodingldpc_torch.kernels import lut_columns as p1
    from informationbottleneckdecodingldpc_torch.utils.peaks import differenced_rate

    dev, steps = torch.device("cuda"), 16
    ms, event_ms, elements_of = {}, {}, {}
    for t1 in p1.CONFIGS:
        for variant in p1.VARIANTS:
            name = p1.variant_name(variant, t1)
            elements = p1.elements_to_fill(variant, t1, dev)
            packed, b0 = (torch.as_tensor(a, device=dev) for a in p1.probe_inputs(t1, elements, seed=17))
            run = lambda n: p1.columns_chain(variant, packed, b0, n)  # noqa: E731
            if not torch.equal(run(steps), p1.columns_chain_plain(packed, b0, steps)):
                raise AssertionError(f"{name} disagrees with its plain version")
            rate = differenced_rate(run, elements, loops=steps, min_seconds=0.1)
            ms[name] = elements * steps / rate * 1e3
            event_ms[name] = cuda_ms(lambda: run(steps), reps)
            elements_of[name] = elements
            print(f"{name}: {elements} elements, {ms[name]:.5f} ms a 16-step launch (differenced; "
                  f"{rate / 1e9:.2f} G element-steps/s), {event_ms[name]:.5f} ms a launch (events)",
                  flush=True)
    return {"reps": reps, "column_ms_per_16_steps": ms, "column_event_ms": event_ms,
            "column_elements": elements_of}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    p.add_argument("--tree", default=str(TREE))
    p.add_argument("--out", default="")
    p.add_argument("--reps", type=int, default=5)
    only = p.add_mutually_exclusive_group()
    only.add_argument("--reads", action="store_true", help="time the read probes P2/P3 only")
    only.add_argument("--columns", action="store_true", help="time the column probe P1 only")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_times runs on a CUDA device only")
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    times = read_times if args.reads else column_times if args.columns else run
    out = {"tree": str(tree), **times(args.reps), "card": nvidia_smi()}
    print(json.dumps(out), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
