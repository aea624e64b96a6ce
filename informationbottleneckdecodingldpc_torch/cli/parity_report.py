"""Write the port's parity report from its BER sweep results.

Port of ``scripts/make_parity_report.py``: the same sweeps, sections and
table rows (every point with its error count and the 95% half-width
1.96/sqrt(errors) of its BER; the Eb/N0 read off each curve at BER 1e-4;
the near-threshold design points from ``results/THRESHOLDS.json``, read
only). It reads the port's curves (default ``results/torch/ber/``, where
``cli/queue.py`` writes them) and writes ``results/torch/PARITY.md``, never
the JAX package's ``results/ber/`` or ``PARITY.md``. The header names the
card the sweeps ran on, as ``nvidia-smi`` gives its name and power limit
when the report is written ("card not recorded" without ``nvidia-smi``).
Where the JAX report states its own curves' readings in prose and in the
anchors table, this one computes them from the curves it reads.

Usage:
  python -m informationbottleneckdecodingldpc_torch.cli.parity_report \\
      [--results-dir results/torch/ber] [--thresholds results/THRESHOLDS.json] \\
      [--out results/torch/PARITY.md]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

SWEEPS = [
    ("wlan_ib_T16_enc", "WLAN 802.11n N=1296 — IB LUT |T|=16, encoded chain, i_max=50"),
    ("wlan_ib_T32_enc", "WLAN 802.11n N=1296 — IB LUT |T|=32, encoded chain, i_max=50"),
    ("wlan_bp_enc", "WLAN 802.11n N=1296 — quantized BP (16-level LLR), encoded chain"),
    ("wlan_minsum_enc", "WLAN 802.11n N=1296 — min-sum (16-level LLR), encoded chain"),
    ("regular_ib_allzero", "Regular (3,6) N=8000 — IB LUT |T|=16 designed @1.05 dB with exact-DP DE (the reference sim's operating point; BELOW the |T|=16 DE threshold — see design-point analysis), all-zeros, i_max=250"),
    ("regular_ib_sib105", "Regular (3,6) N=8000 — IB LUT |T|=16 designed @1.05 dB with the reference's randomized-sIB DE (nror=10), all-zeros, i_max=250"),
    ("regular_ib_d125", "Regular (3,6) N=8000 — IB LUT |T|=16 designed @1.25 dB (above threshold, DE converges, MI 1.0), all-zeros, i_max=250"),
    ("regular_minsum", "Regular (3,6) N=8000 — min-sum benchmark, i_max=50"),
    ("dvbs2_ib_enc", "DVB-S2 N=64800 (ETSI matrix) — IB LUT |T|=16 designed @0.6 dB (reference setting; below the |T|=16 DE threshold — see design-point analysis), encoded chain"),
    ("dvbs2_ib_enc_d08", "DVB-S2 N=64800 (ETSI matrix) — IB LUT |T|=16 designed @0.8 dB (converged DE, MI 0.957), encoded chain, i_max=50"),
    ("dvbs2_minsum", "DVB-S2 N=64800 (ETSI matrix) — min-sum benchmark, i_max=50"),
    ("dvbs2_minsum_T32", "DVB-S2 N=64800 (ETSI matrix) — min-sum benchmark at |T|=32 (the reference's argv mode, DVB-S2/BER_simulation_OpenCL_min_sum.py:49-50), i_max=50"),
    ("wlan_minsum_qam16", "WLAN 802.11n N=1296 — min-sum over 16-QAM (exact soft demapper), encoded chain — the M-ary path the reference intended but left broken (AWGN_Quantizer_Mary absent)"),
]
WLAN_GAPS = ("wlan_bp_enc", "wlan_ib_T16_enc", "wlan_ib_T32_enc", "wlan_minsum_enc")
LONG_GAPS = ("regular_ib_d125", "regular_ib_allzero", "regular_ib_sib105",
             "regular_minsum", "dvbs2_ib_enc_d08", "dvbs2_minsum")
REGULAR_BP_THRESHOLD_DB = 1.102  # continuous BP, regular (3,6) (Richardson & Urbanke)
# The anchors' reading of the DVB-S2 curve: "within ~0.1 dB of the standard's
# ~1.0 dB operating region" when its BER at 1.1 dB is at most this.
QEF_BER = 1e-6


def load(results_dir: str, name: str) -> list[dict] | None:
    p = os.path.join(results_dir, f"{name}.json")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return json.load(f)["points"]


def ci95(p: dict) -> float:
    """95% relative half-width of the BER estimate (Poisson errors)."""
    n = p["errors"]
    return 1.96 / math.sqrt(n) if n > 0 else float("inf")


def interp_db_at_ber(points: list[dict], target: float) -> float | None:
    """Eb/N0 at which the curve crosses ``target`` (log-linear interpolation)."""
    prev = None
    for p in points:
        if p["ber"] <= target and prev and prev["ber"] > target:
            x0, y0 = prev["ebn0_db"], math.log10(prev["ber"])
            x1, y1 = p["ebn0_db"], math.log10(max(p["ber"], 1e-12))
            t = (math.log10(target) - y0) / (y1 - y0)
            return x0 + t * (x1 - x0)
        prev = p
    return None


def ber_at(points: list[dict] | None, ebn0_db: float) -> float | None:
    """The BER of the curve's point at ``ebn0_db``, if it has one."""
    for p in points or ():
        if abs(p["ebn0_db"] - ebn0_db) < 1e-9:
            return p["ber"]
    return None


def short_e(x: float) -> str:
    """``1.1e-5`` for 1.09e-5: one decimal, no zero-padded exponent."""
    mantissa, exponent = f"{x:.1e}".split("e")
    return f"{mantissa}e{int(exponent)}"


def card_line() -> str:
    """The card's name and power limit from ``nvidia-smi``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired):
        return "card not recorded"
    text = out.stdout.strip()
    return text if out.returncode == 0 and text else "card not recorded"


def design_point_section(thresholds_path: str) -> list[str]:
    if not os.path.exists(thresholds_path):
        return ["_(results/THRESHOLDS.json not yet generated)_", ""]
    with open(thresholds_path) as f:
        t = json.load(f)
    reg = t.get("regular_1.05_T16_trajectories_final", {})
    dvb = t.get("dvbs2_0.6_T16_trajectories_final", {})
    o = [
        "The reference simulates the regular code from a config generated at",
        "1.05 dB (Regular_LDPC_Decoding/BPSK/BER_simulation_OpenCL.py:35-42) and",
        "generates DVB-S2 configs from 0.6 dB (DVB-S2/decoder_config_generation.py:20).",
        "At both points the discrete DE stalls (MI plateaus < 1). The stall is",
        "**physical — the design points are below the |T|=16 DE threshold — not",
        "an artifact of the exact-DP compression backend**. Evidence",
        "(scripts/threshold_analysis.py, results/THRESHOLDS.json; the port's",
        "construction rebuilds the committed configs array for array):",
        "",
        "1. **Backend comparison at the design points.** Final DE MI after the",
        "   full iteration budget, exact DP vs the reference's randomized",
        "   sequential sIB (nror=10, three seeds):",
        "",
        "   | design point | DP | " + " | ".join(
            k for k in sorted(reg) if k != "dp") + " |",
        "   |---|---|" + "---|" * 3,
        "   | regular 1.05 dB (i_max=250) | " + " | ".join(
            f"{reg.get(k, float('nan')):.4f}" for k in ["dp"] + sorted(
                k for k in reg if k != "dp")) + " |",
        "   | DVB-S2 0.6 dB (i_max=50) | " + " | ".join(
            f"{dvb.get(k, float('nan')):.4f}" for k in ["dp"] + sorted(
                k for k in dvb if k != "dp")) + " |",
        "",
        "   Every randomized trajectory stalls at (slightly below) the DP",
        "   plateau. Full trajectories: results/de_trajectories_*.npz.",
        "",
        "2. **DE convergence thresholds** (bisection, MI >= 0.999 within the",
        "   iteration budget):",
        "",
        "   | ensemble | backend / \\|T\\| | threshold (dB) | design point |",
        "   |---|---|---|---|",
    ]

    def row(label, key, design):
        v = t.get(key)
        return f"   | {label} | {v:.3f} | {design} |" if v is not None else None

    rows = [
        row("regular (3,6), i_max=250 | DP, T=16", "regular_T16_dp_threshold_db", "1.05 (below)"),
        row("regular (3,6), i_max=250 | sIB nror=10, T=16", "regular_T16_sib_threshold_db", "1.05 (below)"),
        row("regular (3,6), i_max=250 | DP, T=32", "regular_T32_dp_threshold_db", "—"),
        row("DVB-S2 R=1/2, i_max=50 | DP, T=16", "dvbs2_T16_dp_threshold_db", "0.6 (below)"),
        row("DVB-S2 R=1/2, i_max=50 | sIB nror=10, T=16", "dvbs2_T16_sib_threshold_db", "0.6 (below)"),
        row("DVB-S2 R=1/2, i_max=50 | DP, T=32", "dvbs2_T32_dp_threshold_db", "—"),
    ]
    o += [r for r in rows if r]
    o += [
        "",
        "3. **Information-theoretic floor.** Quantized message passing is a",
        "   degraded version of continuous BP (each IB compression is a",
        "   T -> T' deterministic map; data-processing inequality), so the",
        "   |T|=16 DE threshold is lower-bounded by the ensemble's continuous",
        "   BP threshold: for regular (3,6), sigma* = 0.8809",
        "   (Richardson & Urbanke) = **1.102 dB** — already above the 1.05 dB",
        "   design point before any quantization loss.",
        "",
        "Consequence: decoders built at 1.05 dB / 0.6 dB carry stalled-DE late",
        "iterations and show error floors with *either* backend; the working",
        "operating points are the converged designs (regular 1.25 dB, DVB-S2",
        "0.8 dB), also included.",
        "",
    ]
    return o


def anchors_section(curves: dict, thresholds_path: str) -> list[str]:
    """The JAX report's anchors (published thresholds and limits), each beside
    this report's curves: their readings are computed here."""
    t = {}
    if os.path.exists(thresholds_path):
        with open(thresholds_path) as f:
            t = json.load(f)
    o = [
        "## Quantitative anchors vs published theory ([LB18] acceptance check)",
        "",
        "The reference's acceptance test is agreement with the published",
        "curves in [LB18]/[SLB18]. Those figures are not digitizable offline,",
        "so each curve below is held against *independently verifiable*",
        "published numbers — ensemble thresholds and capacity limits — which",
        "bound where each waterfall may sit. The readings are computed from",
        "this report's curves.",
        "",
        "| Anchor (published, offline-verifiable) | Value | Repo measurement | Consistency |",
        "|---|---|---|---|",
        "| Shannon limit, rate-1/2 binary-input AWGN | 0.187 dB | — | every measured waterfall is to the right |",
    ]
    d125, minsum = curves.get("regular_ib_d125"), curves.get("regular_minsum")
    b18, b19 = ber_at(d125, 1.8), ber_at(d125, 1.9)
    if b18 is None or b19 is None:
        measured, reading = "regular_ib_d125 at 1.8 and 1.9 dB not yet run", "—"
    else:
        measured = (f"IB \\|T\\|=16 @1.25 dB design: BER {short_e(b18)} at 1.8 dB, "
                    f"{short_e(b19)} at 1.9 dB (N=8000, i_max=250)")
        reading = (f"waterfall {1.8 - REGULAR_BP_THRESHOLD_DB:.1f}-"
                   f"{1.9 - REGULAR_BP_THRESHOLD_DB:.1f} dB right of the *infinite-length, "
                   "unquantized* threshold — the expected finite-length (N=8000) + 4-bit "
                   "quantization offset")
        ib_db = interp_db_at_ber(d125, 1e-4)
        ms_db = interp_db_at_ber(minsum, 1e-4) if minsum else None
        if ib_db is not None and ms_db is not None:
            gap = ms_db - ib_db
            reading += (f"; sits {abs(gap):.1f} dB {'LEFT' if gap > 0 else 'RIGHT'} of min-sum "
                        f"({ms_db:.2f} dB @1e-4)"
                        + (", as [LB18] reports" if gap > 0 else ", unlike [LB18]"))
    o.append("| Continuous-BP DE threshold, regular (3,6) ensemble (Richardson & Urbanke, "
             f"sigma\\*=0.8809) | 1.102 dB | {measured} | {reading} |")
    dp, sib = t.get("regular_T16_dp_threshold_db"), t.get("regular_T16_sib_threshold_db")
    if dp is not None and sib is not None:
        lo, hi = sorted((dp - REGULAR_BP_THRESHOLD_DB, sib - REGULAR_BP_THRESHOLD_DB))
        o.append(f"| Measured \\|T\\|=16 discrete-DE threshold (this repo, exact DP): {dp:.3f} dB; "
                 f"reference's own sIB backend: {sib:.3f} dB | {dp:.2f} dB | same curve | "
                 f"quantization loss vs continuous BP = {lo:.2f}-{hi:.2f} dB at \\|T\\|=16 — "
                 "matches [LB18]'s ~0.1 dB claim for 4-bit IB decoders |")
    d08 = curves.get("dvbs2_ib_enc_d08")
    b10, b11 = ber_at(d08, 1.0), ber_at(d08, 1.1)
    if b10 is None or b11 is None:
        measured, reading = "dvbs2_ib_enc_d08 at 1.0 and 1.1 dB not yet run", "—"
    else:
        measured = (f"IB \\|T\\|=16 @0.8 dB design: BER {short_e(b10)} @1.0 dB, "
                    f"{short_e(b11)} @1.1 dB")
        reading = ("4-bit LUT decoder reaches the standard's operating region within ~0.1 dB"
                   if b11 <= QEF_BER else
                   f"4-bit LUT decoder above BER {short_e(QEF_BER)} at 1.1 dB, 0.1 dB above "
                   "the standard's operating region")
    o.append("| DVB-S2 R=1/2 N=64800: standard's quasi-error-free target ~1 dB Eb/N0 at 50 "
             f"iterations (ETSI EN 302 307 design point) | ~1.0 dB | {measured} | {reading} |")
    at = {n: interp_db_at_ber(curves[n], 1e-4) for n in WLAN_GAPS if n in curves}
    if len(at) < 4 or None in at.values():
        measured, reading = "not every WLAN curve reaches 1e-4", "—"
    else:
        bp, t16, t32, ms = (at[n] for n in WLAN_GAPS)
        measured = (f"measured @1e-4: BP {bp:.2f}, IB T16 {t16:.2f} ({t16 - bp:+.2f}), "
                    f"IB T32 {t32:.2f} ({t32 - bp:+.2f}), min-sum {ms:.2f} ({ms - bp:+.2f})")
        reading = "reproduced" if wlan_order_holds(at) else "not reproduced"
        gaps = [abs(at[n] - bp) for n in WLAN_GAPS[1:]]
        if max(ci_db(curves[n], 1e-4) for n in WLAN_GAPS) < min(gaps) / 4:
            reading += ", with MC CIs far below the gaps"
    o.append("| WLAN quantized-BP vs IB ordering ([LB18] Fig. ordering claim) | IB within "
             f"~0.1-0.3 dB of BP; min-sum ~0.5 dB worse | {measured} | {reading} |")
    o.append("")
    return o


def ci_db(points: list[dict], target: float) -> float:
    """The 95% half-width of the curve's BER, as Eb/N0 (dB) at the local
    slope, at the larger of the two points around its ``target`` crossing."""
    for prev, p in zip(points, points[1:]):
        if p["ber"] <= target < prev["ber"]:
            slope = abs(math.log10(prev["ber"]) - math.log10(max(p["ber"], 1e-12))) / (
                p["ebn0_db"] - prev["ebn0_db"])
            return max(math.log10(1 + ci95(q)) for q in (prev, p)) / slope
    return math.inf


def wlan_order_holds(at: dict) -> bool:
    """[LB18]'s ordering at BER 1e-4: both IB curves within 0.3 dB of BP,
    |T|=32 no worse than |T|=16, and min-sum worse than both."""
    bp, t16, t32, ms = (at[n] for n in WLAN_GAPS)
    return abs(t16 - bp) <= 0.3 and abs(t32 - bp) <= 0.3 and t32 <= t16 and ms > max(t16, t32)


def report(results_dir: str, thresholds_path: str, card: str) -> tuple[str, int]:
    """The report's text and the number of curves it holds."""
    out = ["# PARITY — BER curves at the reference operating points", ""]
    out += [
        f"Card: {card}.",
        "",
        "All sweeps ran on the card named in the header via the port's CLI",
        "(`informationbottleneckdecodingldpc_torch.cli.simulate`), full Monte-Carlo",
        "chains as in the reference scripts (encoded: random info bits -> GF(2)",
        "encode -> BPSK -> AWGN -> |T_ch|-level IB quantizer -> decode; error",
        "counting on systematic bits; reference stopping rule min_errors per",
        "point). Raw points: `results/torch/ber/*.json`. `±95%` is the relative",
        "95% confidence half-width of the BER estimate (1.96/sqrt(errors));",
        "regenerate everything with",
        "`python -m informationbottleneckdecodingldpc_torch.cli.queue`.",
        "",
        "Reading the `coded Mbit/s` columns: each point's throughput is",
        "wall-clock over the WHOLE point, including the per-point quantizer",
        "construction and first launches, so points of few blocks under-read",
        "the steady state. Steady-state numbers live in",
        "`results/torch/BENCH_MATRIX.json`.",
        "",
    ]
    out.append("## Near-threshold design points (1.05 dB regular / 0.6 dB DVB-S2)\n")
    out += design_point_section(thresholds_path)

    curves = {}
    for name, title in SWEEPS:
        pts = load(results_dir, name)
        if pts is None:
            out.append(f"## {title}\n\n_(not yet run)_\n")
            continue
        curves[name] = pts
        out.append(f"## {title}\n")
        out.append("| Eb/N0 (dB) | BER | ±95% | errors | FER | blocks | coded Mbit/s |")
        out.append("|---|---|---|---|---|---|---|")
        for p in pts:
            out.append(
                f"| {p['ebn0_db']:.1f} | {p['ber']:.3e} | ±{ci95(p)*100:.0f}% "
                f"| {p['errors']} | {p['fer']:.3e} "
                f"| {p['blocks']} | {p['coded_bits_per_s']/1e6:.1f} |"
            )
        out.append("")

    out.append("## Decoder gaps (Eb/N0 at BER = 1e-4, interpolated)\n")
    out.append("| Curve | Eb/N0 @ 1e-4 (dB) | vs quantized BP (dB) |")
    out.append("|---|---|---|")
    base = interp_db_at_ber(curves["wlan_bp_enc"], 1e-4) if "wlan_bp_enc" in curves else None
    at = {}
    for name in WLAN_GAPS:
        if name not in curves:
            continue
        db = interp_db_at_ber(curves[name], 1e-4)
        if db is None:
            continue
        at[name] = db
        delta = "" if base is None else f"{db - base:+.2f}"
        out.append(f"| {name} | {db:.2f} | {delta} |")
    out.append("")
    if len(at) == len(WLAN_GAPS):
        verdict = ("reproduce that ordering" if wlan_order_holds(at)
                   else "do not reproduce that ordering")
    else:
        verdict = "do not cover every curve of that ordering yet"
    out.append(
        "Expected from [LB18] (the reference's paper): the discrete IB decoder"
        " operates within ~0.1-0.3 dB of (quantized) belief propagation and"
        f" clearly outperforms min-sum; |T|=32 closes the gap further. The"
        f" measured gaps above {verdict}."
    )
    out.append("")
    out.append("## Regular (3,6) N=8000 and DVB-S2 N=64800 gaps vs min-sum\n")
    out.append("| Curve | Eb/N0 @ BER 1e-4 (dB) |")
    out.append("|---|---|")
    for name in LONG_GAPS:
        if name not in curves:
            continue
        db = interp_db_at_ber(curves[name], 1e-4)
        out.append(
            f"| {name} | "
            f"{'not reached in sweep range' if db is None else f'{db:.2f}'} |"
        )
    out.append("")
    out += anchors_section(curves, thresholds_path)
    return "\n".join(out), len(curves)


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--results-dir", default=str(REPO / "results/torch/ber"))
    p.add_argument("--thresholds", default=str(REPO / "results/THRESHOLDS.json"))
    p.add_argument("--out", default=str(REPO / "results/torch/PARITY.md"))
    args = p.parse_args(argv)
    text, n = report(args.results_dir, args.thresholds, card_line())
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(text)
    print(f"wrote {args.out} with {n} curves")
    return text


if __name__ == "__main__":
    main()
