"""Smoke run of the PyTorch port on one CUDA card.

Drives the port's main paths through the CUDA kernels and checks them: the
headline BER simulation (WLAN 802.11n N=1296, IB decoder |T|=16 with message
alignment, i_max=50, all-zeros chain, batch 4096 x 8 steps) through K1; the
float decoders' cells (min-sum and BP on 16-level quantized LLRs, 2.0 dB,
i_max 50, the same batch) and the encoded chain through K2; the DVB-S2
R=1/2 N=64800 cells (IB |T|=16 on the encoded chain, min-sum on quantized
LLRs, 1.0 dB, i_max 50, batch 1024) through the device-memory kernels K3 and
K4; the benchmark matrix through K5 and K6; the probes P1-P6 through their
entry point; the channel input of every Monte-Carlo step (its per-codeword
draws and what the decoder reads of them) through the Philox kernel; and the
M-ary chains (WLAN min-sum on 16-QAM and 8-PSK through the exact soft
demapper, batch 512 x 8 steps, i_max 50) through the Philox kernel's bits
and normal planes and K2 (K4 on DVB-S2), with the resumable sweep and the
CLI; data-parallel decoding over ``torch.distributed`` (ranks as processes
of their own, NCCL at world size 1, two gloo ranks sharing the card) and
the port's decoder construction; the quantizer class, the keyed samplers,
the decoder factory and the results queue with its parity report.

1. the card exists (else this raises); its name and power limit;
2. K1 builds from ``csrc/ib_lut_fused.cu`` with nvcc (K2 builds beside it):
   its threads per CTA, registers and spills of each instantiation (the
   per-lane one included);
3. K1 against its plain PyTorch twin on the same CUDA inputs, bit-exact
   (outputs, unsatisfied counts, mean iterations), each case with the path
   it took (per-lane tables and 4-bit views at WLAN |T|=16, one table copy a
   block otherwise): |T|=16 at 0.8 and 6.0 dB with early exit on and off,
   |T|=32 at 0.8 dB fixed and at 6.0 dB with early exit, a batch of 500 (the
   last 16-codeword tile padded), no alignment, three tiles that leave after
   an even number of bodies, after an odd one and not at all (drawn at fixed
   levels, each tile's count from the twin), i_max 1, 2 and 3 at 8.0 dB with
   early exit on and off; the benchmark's sizes, |T|=16 at 0.8 dB and batch
   4096 and |T|=32 at 0.6 dB and batch 2048; and the regular (3,6) N=8000
   code at tile 4 (i_max 250 cut to 20 for the twin) with early exit on and
   off;
4. the headline simulation: coded Mbit/s, one K1 and one channel-input
   launch per Monte-Carlo step and no plane launch, FER and BER at 0.8 dB
   inside bands around the JAX package's reference curve, mean iterations at
   0.8 and 2.4 dB; one dispatch counts the same errors, frame errors and
   mean iterations through the channel-input kernel as through its plain
   version;
5. one decode at batch 4096 by K1 (early exit on and off) and by the twin,
   timed;
6. K2 built from ``csrc/float_fused.cu``: build time, the threads per CTA
   of each rule, registers and spills of each rule's kernel;
7. K2 against its plain twin on the same CUDA inputs, both rules, WLAN,
   i_max 50, batch 512 (the last 5-codeword tile padded): quantized LLRs at
   2.0 dB with early exit on and off, at 4.0 dB (tiles exit after different
   bodies), true LLRs at 2.0 dB, i_max 1 with early exit on and off, i_max 2
   and 3 at 4.0 dB with early exit on and off, and three tiles that leave
   after an even number of bodies, after an odd one and not at all (drawn
   at ``WLAN_MIXED_DB``, each tile's count from the twin). Outputs (``==``,
   so +0 == -0), unsatisfied counts and mean iterations must be equal for
   min-sum and for BP: K2 and torch on the card both take expf/log1pf from
   CUDA's math library;
8. the two float cells: coded Mbit/s and mean iterations, one K2 launch per
   Monte-Carlo step;
9. the encoded chain against the JAX package's reference curves, 32768
   blocks each: min-sum at 1.6 dB, BP at 1.2 dB, IB (K1) at 0.8 dB; FER and
   BER inside bands of about 3 sigma of both samples; BP on the encoded
   chain and min-sum on the all-zeros chain with true LLRs, 32768 blocks,
   FER and BER below the top of those bands; one channel-input launch a
   step (and one info-bit plane an encoded step), no uniform or normal
   plane;
10. one decode at batch 4096 per rule by K2 and by the plain whole-batch
    decoder, early exit off (the two compute the same result), timed; K2
    with early exit on at 2.0 dB, timed;
11. K3 and K4 built from ``csrc/ib_lut_hbm.cu`` and ``csrc/float_hbm.cu``
    beside K1 and K2: build times, registers and spills per kernel, each
    wide instantiation named (K3's per-lane CN and VN passes at 8 bytes and
    its general ones at 4, K4's per rule and degree range);
12. K3 against its plain twin on the same CUDA inputs, bit-exact (outputs,
    unsatisfied counts, mean iterations), tiles of 128 unless stated:
    DVB-S2 |T|=16 designed at 0.6 dB at 1.0 dB, batch 256, early exit on
    and off; designed at 0.8 dB at 9.0 dB, batch 512 (tiles exit after
    different bodies); a batch of 200 (the last tile padded); batch 512 in
    tiles of 256; WLAN |T|=16 at 0.8 dB, batch 512 (its degree-11 variable
    nodes run in the general VN kernel), also in tiles of 200 and of 1024
    (batch 1024); WLAN |T|=32 (every node in the general kernels: the
    per-lane tables do not fit);
13. K4 against its plain twin, both rules, DVB-S2, batch 256: quantized LLRs
    at 1.0 dB with early exit on and off, at 9.0 dB (batch 512, tiles exit),
    true LLRs, i_max 1, i_max 2 with early exit on and off, three tiles
    that leave after an even number of bodies, after an odd one and not at
    all (drawn at ``DV_MIXED_DB``, each tile's count from the twin), batch
    512 in tiles of 256; WLAN at batch 512, also in tiles of 200 and of
    1024 (batch 1024); LLRs that force ties, +0 and -0 inputs and values
    above the clamp (batch 256, and 400 in tiles of 200 at i_max 20 with
    early exit off). Equal (``==``) for min-sum and BP alike; min-sum runs
    on the node-state path (``state_launches`` equal to ``launches``, 0 for
    BP) and equals K4's view path bit for bit (int32 views, the sign of a
    zero too);
14. the DVB-S2 cells through BERSimulator (``backend`` 'auto' picks K3/K4):
    coded Mbit/s, one decode per Monte-Carlo step; FER and BER over 8192
    blocks inside bands of about 3 sigma of the run and the reference's 128
    blocks around ``results/ber/dvbs2_*.json``: IB encoded at 1.0 dB
    (designed at 0.6 dB) and 0.9 dB (designed at 0.8 dB), min-sum all-zeros
    at 1.0 dB; one channel-input launch a step and one info-bit plane an
    encoded step, no uniform or normal plane; one ``dvbs2_ib_hbm_encoded``
    dispatch counts the same through the channel-input kernel as through
    its plain version; BP through run_point and IB through the CLI,
    briefly;
15. one DVB-S2 decode at batch 1024, early exit off, by K3 and K4 (both
    rules) and by the plain whole-batch decoders, timed; outputs equal; K4
    min-sum with early exit on at 1.0 dB (no tile leaves), timed; per-pass device times and launches (seed,
    CN, VN, exit, syndrome, decision) of K3, K4 min-sum with early exit on
    and K4 BP from ``torch.profiler``, K4 with early exit held to one CN,
    exit and VN launch per body and one syndrome pass; K4 min-sum's
    node-state CN and VN passes a body beside their device-memory bytes, at
    slices of 32 columns and of 16;
16. the peak microkernels K5 (``csrc/peaks.cu``) and the copy K6
    (``csrc/hbm_copy.cu``), built beside K1-K4: registers and spills; each
    K5c op's instructions per application in its chain loop (``cuobjdump
    -sass``) by pipe class and issue beside the roofline's count, and its
    busiest class;
17. each K5 variant (1-D lookups, 2-D lookups with the tables shared by a
    block and copied per lane, each at |T| 16 and 32; the four float ops)
    against its plain version on the card, equal (``==``), at 16 loops over
    the thread count the peak measurement launches, and K6 over one 256 MB
    pass and over 256 MB + 12,345 bytes (not a whole number of its chunks),
    each timed;
18. the peaks (lookups/s, float op applications/s, each against its
    per-pipe bound: the busiest of its classes and the issue limit) and K6's copy bandwidth against ``copy_`` and the data
    sheet's 3.35 TB/s (above 1.05 x that the byte count is wrong: raise);
19. the regular (3,6) N=8000 code: K2 (one codeword per CTA) bit-exact
    against its twin (K1's cases are phase 3's); IB
    at 1.2 dB and min-sum at 1.7 dB over 8192 blocks inside bands of about
    3 sigma around ``results/ber/regular_*.json``;
20. the benchmark matrix's entry point over all 12 cells with its K5 peaks
    and the copy bandwidth (the faster of K6 and ``copy_``): one line per
    cell (Mbit/s, mean iterations, backend, decoder launches, bound and
    fraction of it; every fraction must be at most 1), and K1-K4's bounds at
    the shapes of phases 5, 10 and 15;
21. the probes P1 (``csrc/lut_columns.cu``), P2/P3 (``csrc/bulk_read.cu``)
    and P4 (``csrc/bulk_copies.cu``), built beside K1-K6: registers, shared
    memory and spills of each kernel;
22. P1, CUDA cores and tensor cores at |T1| 16 and 32, equal (``==``) to the
    plain chain at 16 loops over the elements that fill the card (blocks per
    SM printed), each timed by events beside ``index_select``'s build of the
    same columns (no extract), its loop's SASS per element-step by class
    beside the bound's extract and update (``roofline.COLUMN_STEP_OPS``,
    which no class of the loop may fall under);
    then the probe entry point's P1, every variant launched: its rate
    differenced over steps in one launch, the device time of a 16-step
    launch it gives (the time the kernels' line records) and its share of
    the per-pipe bound (``utils/probes.py`` ``column_bound``);
23. P2/P3, every read variant and chunk size (seq, 7 strided streams at 4,
    16 and 48 KB; the table and nested variants at 4 and 16 KB) over the 256
    MB source on one block per SM, with its slots and bytes in flight per
    SM: per-block checksums of one pass equal to the plain version (the ring
    variants also at two blocks per SM), each timed by events over 5 calls
    beside its library call (``x.sum()`` for seq, the sum of the 7 planes it
    reads for the others, whose total equals its checksums'); then the
    entry point's P2/P3, each rate against 3.35 TB/s and ``copy_`` of phase
    18 (above 1.05 x 3.35 TB/s the byte count is wrong: raise), and a pass's
    device time from it (bytes over the rate differenced over passes in one
    launch), the time the kernels' line records;
24. P4, scatter and stage at 512 B, 16 KB and 128 KB as the card-wide wave
    (512 copies dealt over one block per SM, 8 issuing warps a block) and on
    one block (one SM's issue cost), at 512 B and 16 KB as a wave on each of
    132 blocks, and at 16 KB on one block with 8 and 2 copies per wait:
    after two waves the scatter's destination and the stage's checksums
    equal to the plain versions, one wave timed on the card beside the one
    PyTorch call of the same copies (``index_copy_`` for the scatter,
    ``index_select`` and a sum for the stage); then the entry point's P4:
    microseconds per copy and per wait, effective GB/s and the library
    call's, with the same raise;
25. the channel-input kernel (``csrc/philox_planes.cu``), P5
    (``csrc/stage_chunks.cu``) and P6 (``csrc/stage_replay.cu``), built
    beside K1-K6 and P1-P4: registers, shared memory and spills of each
    kernel; each channel-input kind's instructions per pipe on one thread's
    trip (``cuobjdump -sass``, the special-value paths of the math library
    left out) beside the roofline's count;
26. every fused kind of the channel-input kernel equal (``==``) to its plain
    version (the plane, then the quantizer and AWGN operators) and to the
    parent's composition (the plane kernel, then those operators) on the
    cells' shapes (:data:`CHANNEL_INPUT_CASES`: the headline's uniform ->
    clusters and -> LLRs, WLAN |T|=32, WLAN encoded IB, min-sum and BP true,
    DVB-S2 encoded IB and min-sum, all-zeros true LLRs, a shard of odd
    batch), each timed (the card's time, queued behind a sleep) beside the
    composition and its bound from the SASS counts; the planes (uniform,
    normal, info bits) equal to theirs, also on a ragged shape; the launches
    are those of phases 4, 9 and 14, counted from 0 around each (the uniform
    and normal planes are on no main path since the kernel took the channel
    input over, and say so in their records);
27. P5, every variant (base, dynsem, pipeline, vwrite, unalign) on the 303 MB
    source: per-block checksums of two iterations equal to the plain version,
    one iteration timed against 293.6 MB at 3.35 TB/s;
28. P6 (K3's wide passes with the folds replaced), every variant (exact,
    nochv, cn_only, vn_only, nosmall, nowrite, staged) on DVB-S2 at batch
    1024: views and checksums after two bodies equal to the plain version,
    one body timed against its view traffic at 3.35 TB/s, beside K3's ms per
    body from phase 15;
29. the probe entry point's P5 and P6 with the launch counts reset: ms per
    iteration or body, GB/s and the fraction of the bound of every variant,
    K3's ms per body beside P6 and K3's less P6 exact's, the folds' share of
    a body (above 1.05 x 3.35 TB/s: raise);
30. the map and the demap on the card against the CPU on the same bits and
    noise (WLAN, batch 512, n0 of 3.5 dB): 16-QAM, 64-QAM and 8-PSK symbols
    and received values equal (``==``), LLRs within the CPU tests'
    tolerance (``MARY_LLR_RTOL`` of max(1, |ref|)); K2 min-sum on the
    card's 16-QAM LLRs equal to its plain twin on the card;
31. the WLAN min-sum 16-QAM chain at ``scripts/queue.py``'s settings
    (batch 512 x 8 steps, i_max 50, seed 33): coded Mbit/s; one info-bit
    plane, one normal plane and one K2 launch a step and no fused channel
    input; FER and BER over 32768 blocks at 3.5 and 4.2 dB inside bands
    around ``results/ber/wlan_minsum_qam16.json``; one dispatch's counters,
    its bits and normal planes equal to ``plane_plain`` on the card, and the
    count of elements in which the CPU's plain normals differ from the
    card's (last bits);
32. the 8-PSK chain (seed 34): coded Mbit/s, FER at ``PSK_POINTS`` falling
    with Eb/N0 (no reference curve); 16-QAM on DVB-S2 through K4
    (``backend='auto'``), batch 1024: coded Mbit/s and one point;
33. one 16-QAM dispatch under ``torch.profiler``, in a process of its own:
    device ms per step of the info-bit plane, the encoder, the normal
    plane, the map, the demap, K2 and the counting, and the idle and demap
    shares of phase 31's wall time;
34. resume on the card: a point stopped by ``on_progress`` after 2
    dispatches and resumed from its saved ``partial`` counts what the
    uninterrupted point does; the CLI sweeps 8-PSK over 2 points into a
    results file, and a rerun with a higher ``--max-db`` resumes after them
    without recomputing them; ``--export-npz`` writes the JAX keys;
35. data parallelism over ``torch.distributed``, each rank a process of its
    own started by ``torch.distributed.run`` after every kernel was built
    here (a rank that fails, or
    ranks that outlast ``RANK_TIMEOUT``, end the run): the headline in one rank
    under an NCCL group (``n_devices=1``): one dispatch counts what phase
    4's does (``==``), and its Mbit/s, with an all-reduce a dispatch,
    beside phase 4's;
36. two ranks sharing the card over gloo against one process at the global
    batch, one dispatch each: the headline (4096 a rank, K1) and DVB-S2
    min-sum (1024 a rank, K4) count the same errors and frame errors, mean
    iterations within 1e-6; WLAN min-sum on ``backend='xla'`` (256 a rank x
    4 steps at ``PAIR_XLA_DB``, early exit all-reduced after every body)
    counts the same and runs the same bodies (``==``), leaving early;
37. the CLI's two-rank resume on ``cuda:0`` over gloo (as
    ``tests/test_sim.py:257-335``): rank 0 resumes from its one-point
    results file, rank 1 (whose results path does not exist) from rank 0's
    broadcast and writes nothing; the points equal one process's sweep at
    the global batch;
38. the dry run (``cli/dryrun.py``, K1) at world size 1 over NCCL; the port's
    construction rebuilds the four committed configs on this host, each in
    the seconds printed, every array equal to the committed file (else the
    first differing array and element are printed and the rebuilt
    ``wlan_T16_0.8`` must decode the headline inside phase 4's bands); a
    headline dispatch with the rebuilt ``wlan_T16_0.8`` counts what phase
    4's does.
39. the last public API and the results queue at the headline's width
    (WLAN N=1296, IB |T|=16, ``wlan_T16_0.8``, 4096 codewords): (a)
    ``AWGNChannelQuantizer`` on the card: ``quantize`` and ``quantize_llr``
    of a 1296 x 4096 plane equal (``==``) the CPU class's; the keyed
    samplers (one Philox uniform plane a call) equal the samples of
    ``rng.plane_plain``'s uniforms on the card; the all-zero clusters' shares
    within 5 binomial standard deviations of p(t|x=0); (b)
    ``make_fused_ib_decoder`` decodes those clusters in one K1 launch equal
    to a ``FusedIBDecoder``'s, and on its first two tiles to the twin; (c)
    ``cli/queue.py``'s ``run`` in ``chiprun_out/queue39``: the configs
    stage builds ``wlan_T16_0.8`` (compared with the committed file), the
    ``wlan_ib_T16_enc`` sweep cut to 0.6-0.8 dB at 4096 blocks a point,
    its 0.8 dB point reopened and extended to 8192 blocks equal (errors,
    frame errors, blocks ``==``, mean iterations within 1e-9) to a straight
    run at 8192, and the report stage's ``PARITY.md`` with the card in its
    header; each run's seconds.
40. the encoder kernel (``csrc/encoder.cu``) built: its registers and
    spills; equal (``==``) to its plain version on the card, called twice
    and again after its timing (the staircase path's state reused across
    launches of a shape), at the cells' shapes and ragged ones
    (:data:`ENCODER_CASES`: DVB-S2 N=64800 at 1024, 128, 200 and 7, WLAN at
    512, 4096 and 200; the dense path's streamed rows at m = 4000 with a
    random B^-1, the zoo's regular codes having a singular B); one launch a
    call; each case's device time beside its bound (on the dense path the
    product's AND-XORs beside the bytes) and the plain version's; a fresh
    DVB-S2 encoder alternating batches 1024 and 128 past its 65th call
    (:data:`ENCODER_SHAPE_RUNS`), each call equal to the plain version;
    the engine's encoder launches, dense in phase 9 and staircase in phase
    14 (one an encoded step), each path's count in its own kernels record.

Each phase prints one line per check and its seconds; any failure raises and
exits non-zero. The matrix's JSON goes to ``chiprun_out/BENCH_MATRIX.json``,
the probes' to ``chiprun_out/PROBES_{p1,p2_p3,p4,p5_p6}.json``.
The last lines are the run's total seconds, the kernels' JSON record (the
M-ary path's launches added to K2's, K4's and the planes', phases 35, 36 and
38's ranks' and dispatches' to K1's, K4's and the channel input's, phase
39's to K1's and the uniform plane's, phases 9, 14 and 40's to the
encoder's; phase 37's CLI ranks and phase 39's
queue processes report none), the card's name and power limit, and the
device record.

Usage: python3 chip_smoke.py
"""

from __future__ import annotations

import collections
import dataclasses
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch


# Eb/N0 (dB) of the DVB-S2 exit cases: the degree-1 parity node forwards its
# channel value, so a 128-codeword tile's syndrome clears only when none of
# its codewords has that bit wrong, which takes a high SNR.
DV_EXIT_DB = 9.0
# The Eb/N0 levels (dB) tried for K4's odd/even exit case: DVB-S2 float
# tiles of 128 leave after 2 bodies at 11 dB, after 3 or 4 (or never) at 9
# and 8 dB.
DV_MIXED_DB = (11.0, 9.0, 8.0)
# The Eb/N0 levels (dB) tried for K2's odd/even exit case: WLAN tiles of 5
# leave after about seven bodies on average at 4 dB (phase 7), later at 2.5
# and 3 dB.
WLAN_MIXED_DB = (4.0, 3.0, 2.5)
DV_DISPATCHES = 8  # 8192 blocks per DVB-S2 (and regular) reference point
PASS_KERNELS = ("seed", "cn", "vn", "exit", "syndrome", "decide")  # K3's and K4's passes
CHECK_LOOPS = 16  # K5's loop count when held against its plain version
REG_TWIN_IMAX = 20  # the regular code's twin comparison: i_max 250 cut to 20
K5_REPLACES = {
    "lookup1d": "informationbottleneckdecodingldpc_tpu/utils/peaks.py:102",
    "lookup2d": "informationbottleneckdecodingldpc_tpu/utils/peaks.py:147",
    "lookup2d_lanes": "informationbottleneckdecodingldpc_tpu/utils/peaks.py:147",
    "float": "informationbottleneckdecodingldpc_tpu/utils/peaks.py:190",
}
KERNEL_KEYS = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
               "plain_ms", "bound_ms", "bound_by", "library_ms")
# Phase 40's (code, batch): the encoded cells' shapes (dvbs2_ib.enc_b1024,
# dvbs2_ib.queue_enc128, wlan_ib.queue_enc512, phase 9's WLAN 4096) and
# ragged ones (16- and 1-byte column words; a partial group of 32).
# ENCODER_SHAPE_RUNS: a fresh DVB-S2 encoder's calls, alternating batches
# whose staircase state lays its flags and carries out differently, past the
# 65th call (epoch 64, whose flag tag 0x101 a carry word of 0/1 bytes can
# spell), then one batch past epoch 64 of its own state.
ENCODER_CASES = (
    ("dvbs2-64800", 1024), ("dvbs2-64800", 128), ("dvbs2-64800", 200), ("dvbs2-64800", 7),
    ("wlan-1296", 512), ("wlan-1296", 4096), ("wlan-1296", 200), ("random-dense-4000", 512),
)
ENCODER_SHAPE_RUNS = (1024, 128) * 40 + (1024,) * 70
MARY_BATCH = 512  # scripts/queue.py's M-ary sweeps: batch 512 x 8 steps per dispatch
MARY_DISPATCHES = 8  # 32768 blocks per M-ary point
MARY_LLR_RTOL = 2e-6  # the demappers' tolerance of tests/test_torch_mary.py, of max(1, |ref|)
PSK_POINTS = (3.0, 3.5)  # Eb/N0 (dB) of the 8-PSK points: the curve's waterfall
# Phase 33's landmarks in a step's kernels: the Philox kernel that opens its
# channel input, and the decode kernels (K1, K2 and the passes of K3 and K4).
DRAW_KERNEL = "channel_input_kernel"
DECODE_KERNELS = ("ib_lut_fused_kernel", "float_fused_kernel", "seed_kernel", "cn_kernel",
                  "vn_kernel", "syndrome_kernel", "decide_kernel")
PROBE_LIBRARIES = ("lut_columns", "bulk_read", "bulk_copies")
K5C_LOOPS = {  # float op -> (K5c chain kernel's mangled name, fminf per application)
    "minsum_op": ("float_pair_kernelINS_8MinSumOp", 1), "boxplus": ("float_pair_kernelINS_7BoxPlus", 1),
    "float_mix": ("float_pair_kernelINS_7AddClip", 2), "min": ("float_pair_kernelINS_3Min", 1),
}
LATE_LIBRARIES = ("philox_planes", "stage_chunks", "stage_replay")
PHILOX_PLANES = {  # plane kind -> (rows, batch): rng.draw's planes on the cells' shapes
    "uniform": (1296, 4096),  # the headline's inversion uniforms (off the main path)
    "normal": (64800, 1024),  # DVB-S2 encoded: the noise (off the main path)
    "bits": (32400, 1024),  # DVB-S2 encoded: the info bits
}
# The channel-input kernel's cases: (label, fused kind, rows, batch, |T|,
# Eb/N0 dB, first codeword, whether it is the kind's record). Every code is
# R = 1/2.
CHANNEL_INPUT_CASES = [
    ("headline", "uniform_clusters", 1296, 4096, 16, 0.8, 0, True),
    ("headline min-sum", "uniform_llrs", 1296, 4096, 16, 0.8, 0, False),
    ("WLAN |T|=32", "uniform_clusters", 1296, 2048, 32, 0.6, 0, False),
    ("WLAN encoded IB", "encoded_clusters", 1296, 4096, 16, 0.8, 0, False),
    ("WLAN encoded min-sum", "encoded_llrs", 1296, 4096, 16, 1.6, 0, True),
    ("WLAN encoded BP true", "encoded_true", 1296, 4096, 16, 1.2, 0, True),
    ("dvbs2_ib_hbm_encoded", "encoded_clusters", 64800, 1024, 16, 1.0, 0, True),
    ("DVB-S2 encoded min-sum (no cell runs it)", "encoded_llrs", 64800, 1024, 16, 1.0, 0, False),
    ("dvbs2_minsum", "uniform_llrs", 64800, 1024, 16, 1.0, 0, True),
    ("all-zeros true", "normal_true", 1296, 4096, 16, 1.6, 0, True),
    ("a shard, odd batch", "encoded_clusters", 1296, 1001, 16, 0.8, 12345, False),
]
# Each kind's instantiation with 16-byte stores in csrc/philox_planes.cu
# (channel_input_kernel<draw, consumer, codeword, true>), by mangled name.
CHANNEL_INPUT_KERNELS = {
    kind: f"channel_input_kernelILi{d}ELi{o}ELb{c}ELb1E"
    for kind, (d, o, c) in {
        "bits": (0, 0, 0), "normal": (1, 0, 0), "uniform": (2, 0, 0),
        "uniform_clusters": (2, 1, 0), "uniform_llrs": (2, 2, 0), "normal_true": (1, 3, 0),
        "encoded_clusters": (1, 1, 1), "encoded_llrs": (1, 2, 1), "encoded_true": (1, 3, 1),
    }.items()
}
JAX_ENGINE = "informationbottleneckdecodingldpc_tpu/sim/engine.py"
CHANNEL_INPUT_REPLACES = {  # the JAX engine's line each kind computes
    "uniform_clusters": f"{JAX_ENGINE}:397", "uniform_llrs": f"{JAX_ENGINE}:400",
    "normal_true": f"{JAX_ENGINE}:402", "encoded_clusters": f"{JAX_ENGINE}:434",
    "encoded_llrs": f"{JAX_ENGINE}:436", "encoded_true": f"{JAX_ENGINE}:438",
    "bits": f"{JAX_ENGINE}:408", "normal": f"{JAX_ENGINE}:387", "uniform": f"{JAX_ENGINE}:381",
}
PROBE_REPLACES = {  # a probe variant -> the TPU probe it replaces (the repo's scripts/)
    "cuda_cores": "scripts/mxu_col_probe.py:63",
    "tensor_cores": "scripts/mxu_col_probe.py:102",
    "seq": "scripts/read_bw_probe.py:30",
    "strided": "scripts/read_bw_probe.py:30",
    "table": "scripts/read_bw_probe2.py:31",
    "nested": "scripts/read_bw_probe2.py:31",
    "copies": "scripts/dma_probe.py:36",
    "copies_per_wait": "scripts/dma_probe.py:120",
}


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


def sass_functions(lib_path: str) -> dict[str, list[tuple[int, str, int | None, bool]]]:
    """The instructions of every function in ``cuobjdump -sass`` of a built
    library, by mangled name: (address, opcode, branch target or None,
    predicated)."""
    from informationbottleneckdecodingldpc_torch.kernels._build import _nvcc

    cuobjdump = Path(_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", lib_path], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    out = {}
    for f in re.split(r"\n\s*Function : ", sass)[1:]:
        ins = []
        for addr, pred, op, rest in re.findall(
                r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)([^;]*);", f):
            target = re.search(r"0x([0-9a-f]+)", rest) if op == "BRA" else None
            ins.append((int(addr, 16), op, int(target.group(1), 16) if target else None, bool(pred)))
        out[f.splitlines()[0].strip()] = ins
    return out


def loop_op_counts(lib_path: str, kernel: str, marker: str | None = None) -> dict[str, int]:
    """Instructions per opcode that one trip of the innermost loop of a
    kernel runs on its common path, from ``cuobjdump -sass`` of a built
    library: the first function whose mangled name holds ``kernel``, the
    instructions from the target of its shortest backward branch (of those
    whose loop holds the opcode ``marker``, if given) to that branch, less
    those a predicated forward branch jumps over (the libm calls'
    special-value paths, which finite inputs skip)."""
    ins = next(v for k, v in sass_functions(lib_path).items() if kernel in k)
    loops = [(a, t) for a, op, t, _ in ins if op == "BRA" and t is not None and t < a]
    if marker:
        loops = [(a, t) for a, t in loops if any(op == marker and t <= b <= a for b, op, _, _ in ins)]
    end, start = min(loops, key=lambda at: at[0] - at[1])
    loop = [i for i in ins if start <= i[0] <= end]
    skipped = [(a, t) for a, op, t, pred in loop if op == "BRA" and pred and t is not None and t > a]
    counts: dict[str, int] = {}
    for a, op, _, _ in loop:
        if not any(s < a < t for s, t in skipped):
            counts[op] = counts.get(op, 0) + 1
    return counts


def common_path_counts(ins: list[tuple[int, str, int | None, bool]]) -> dict[str, int]:
    """Instructions per opcode of one pass through a kernel (prologue and one
    trip of its loop) up to its first unpredicated EXIT, less the
    special-value paths of the math library: each range a predicated forward
    branch jumps over that holds a call or an inner loop and no global store
    (a guard around a row's store keeps its range)."""
    end = next(i for i, (_, op, _, pred) in enumerate(ins) if op == "EXIT" and not pred)
    ins = ins[: end + 1]
    skipped = []
    for a, op, t, pred in ins:
        if op == "BRA" and pred and t is not None and t > a:
            inside = [i for i in ins if a < i[0] < t]
            slow = any(o == "CALL" or (o == "BRA" and tt is not None and tt < aa) for aa, o, tt, _ in inside)
            if slow and not any(o == "STG" for _, o, _, _ in inside):
                skipped.append((a, t))
    counts: dict[str, int] = {}
    for a, op, _, _ in ins:
        if not any(s < a < t for s, t in skipped):
            counts[op] = counts.get(op, 0) + 1
    return counts


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


def pass_times(fn) -> dict[str, tuple[float, int]]:
    """Device milliseconds and launches of each of K3's or K4's passes
    (:data:`PASS_KERNELS`, by kernel name) in one call of ``fn`` after a
    warm-up call, from ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out: dict[str, tuple[float, int]] = {}
    for e in prof.key_averages():
        kind = next((k for k in PASS_KERNELS if f"{k}_kernel" in e.key), None)
        if kind is None:
            continue
        us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)
        ms, n = out.get(kind, (0.0, 0))
        out[kind] = (ms + us / 1e3, n + e.count)
    if not out:
        raise AssertionError("the profiler saw no pass kernel on the card")
    return {k: out[k] for k in PASS_KERNELS if k in out}


class Lap:
    """Prints the seconds of each phase as it ends."""

    def __init__(self):
        self.t = time.perf_counter()

    def __call__(self, phase: int) -> None:
        now = time.perf_counter()
        print(f"[{phase} seconds] {now - self.t:.1f}", flush=True)
        self.t = now


def dispatch_point(sim, ebn0_db: float, dispatches: int) -> dict:
    """FER, BER and mean iterations over ``dispatches`` dispatches from step 0
    (the steps ``run_point`` draws), with the standard deviation of the
    dispatches' BERs."""
    qt = sim.quantizer_for(ebn0_db)
    per_dispatch = sim.batch_total * sim.steps_per_dispatch
    bers, frames, iters = [], 0, 0.0
    for k in range(dispatches):
        e, f, it = sim._step(ebn0_db, k * sim.steps_per_dispatch, qt)
        bers.append(int(e) / (per_dispatch * sim.prefix_len))
        frames += int(f)
        iters += float(it)
    blocks = dispatches * per_dispatch
    mean = sum(bers) / dispatches
    sd = math.sqrt(sum((b - mean) ** 2 for b in bers) / (dispatches - 1))
    return dict(blocks=blocks, per_dispatch=per_dispatch, fer=frames / blocks, ber=mean,
                ber_sd=sd, iterations=iters / dispatches)


def ref_bands(point: dict, fer_ref: float, ref_blocks: int = 128) -> tuple[float, float]:
    """3-sigma bands on |FER - reference| and |BER - reference| over both
    samples: FER binomial at the pooled rate; BER from the per-codeword
    spread, estimated by the dispatches' spread times sqrt(codewords per
    dispatch)."""
    n = point["blocks"]
    p = (point["fer"] * n + fer_ref * ref_blocks) / (n + ref_blocks)
    both = 1 / n + 1 / ref_blocks
    per_codeword_sd = point["ber_sd"] * math.sqrt(point["per_dispatch"])
    return 3 * math.sqrt(p * (1 - p) * both), 3 * per_codeword_sd * math.sqrt(both)


def drive_probe(probe: str, *counts) -> tuple:
    """The probe entry point for ``probe`` ('p1', 'p2,p3', 'p4', 'p5,p6')
    with the launch counts ``counts`` set to 0 just before it: the counts it
    left (one dict per counter) and its result."""
    from informationbottleneckdecodingldpc_torch.cli import probes as cli_probes

    for c in counts:
        c.clear()
    out = Path("chiprun_out") / f"PROBES_{probe.replace(',', '_')}.json"
    result = cli_probes.main(["--only", probe, "--out", str(out)])
    return *(dict(c) for c in counts), result


def same_counters(sim, ebn0_db: float, phase: str) -> None:
    """One dispatch of ``sim`` from step 0 through the channel-input kernel
    and through its plain version on the card (``rng.channel_input_plain``
    in place of ``rng.channel_input``) counts the same bit errors, frame
    errors and mean iterations; returns them."""
    from informationbottleneckdecodingldpc_torch.sim import rng

    qt = sim.quantizer_for(ebn0_db)
    fused = [float(v) for v in sim._step(ebn0_db, 0, qt)]
    kernel = rng.channel_input
    rng.channel_input = lambda kind, key, rows, offset, batch, device, tables, sigma2=None, \
        codeword=None: rng.channel_input_plain(kind, key, rows, offset, batch, tables, sigma2,
                                               codeword, device)
    try:
        plain = [float(v) for v in sim._step(ebn0_db, 0, qt)]
    finally:
        rng.channel_input = kernel
    if fused != plain:
        raise AssertionError(f"the kernel's dispatch counts {fused}, the plain version's {plain}")
    print(f"[{phase} counters] one dispatch at {ebn0_db} dB through the channel-input kernel "
          f"and through its plain version: bit errors {fused[0]:.0f}, frame errors {fused[1]:.0f}, "
          f"mean iterations {fused[2]:.4f}, equal", flush=True)
    return fused


def timed_plain(fn):
    """``fn()`` and the milliseconds of a second call after a warm-up one, by
    the host clock around a synchronise."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def column_phase(dev, card: str, builds: dict, record) -> None:
    """Phase 22: P1 on CUDA cores and tensor cores at both T1, each row held
    ``==`` its plain version at the elements that fill the card, its loop's
    SASS per element-step by class, then the probe entry point with the
    launch counts reset: each row's device ms of a 16-step launch beside its
    per-pipe bound, its events time and index_select's build of the same
    columns; the records through ``record``."""
    from informationbottleneckdecodingldpc_torch.kernels import lut_columns as p1
    from informationbottleneckdecodingldpc_torch.utils import probes, roofline
    from informationbottleneckdecodingldpc_torch.utils.peaks import device_ms

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    p1_rows = {}
    for t1 in p1.CONFIGS:
        for variant in p1.VARIANTS:
            name = p1.variant_name(variant, t1)
            elements = p1.elements_to_fill(variant, t1, dev)
            per_sm = elements // (sms * p1.block_elements(variant))
            packed, b0 = (torch.as_tensor(a, device=dev) for a in p1.probe_inputs(t1, elements, seed=17))
            run = lambda: p1.columns_chain(variant, packed, b0, CHECK_LOOPS)
            got = run()
            want, plain_ms_k = timed_plain(lambda: p1.columns_chain_plain(packed, b0, CHECK_LOOPS))
            err = int((got.long() - want.long()).abs().max())
            if not torch.equal(got, want):
                raise AssertionError(f"P1 {variant} T1={t1} disagrees with its plain version ({err})")
            b = roofline.bound(2 * 4 * elements + packed.numel() * 4,
                               probes.column_ops(variant, t1, elements * CHECK_LOOPS))
            # The library call: index_select's build of one step's columns,
            # no extract, times the 16 steps.
            library_ms = device_ms(probes.column_library(packed, b0.long() & (t1 - 1))) * CHECK_LOOPS
            p1_rows[name] = dict(kind=variant, max_abs_err=err, event_ms=cuda_ms(run, reps=5),
                                 plain_ms=plain_ms_k, library_ms=library_ms, bound_ms=b["bound_ms"],
                                 bound_by=b["bound_by"], busiest=b["busiest"], elements=elements)
            # The kernel's loop as compiled, per element-step: lookups per step
            # (CUDA cores) or mma per tile pair (tensor cores) give the steps
            # a trip of the loop runs. The bound's integer work must be no
            # more than the loop runs in each class.
            marker = "LDS" if variant == "cuda_cores" else "IMMA"
            ops = loop_op_counts(builds["lut_columns"]["path"], p1.kernel_name(variant, t1), marker)
            steps = (ops["LDS"] / p1.CUDA_LOADS_PER_STEP[t1] if variant == "cuda_cores"
                     else ops["IMMA"] / (2 * p1.N_TILES[t1]))
            sass = roofline.sass_counts({k: n / steps for k, n in ops.items()}, roofline.INTEGER_PIPE_OPCODES)
            over = {k: n for k, n in roofline.COLUMN_STEP_OPS[t1].items() if sass.get(k, 0) < n}
            if over:
                raise AssertionError(f"P1 {name}: the bound counts more {over} a step than its loop runs "
                                     f"({sass})")
            p1_rows[name]["sass"] = sass
            print(f"[22 exact] P1 {name}: {elements} elements ({per_sm} blocks of "
                  f"{p1.block_elements(variant)} per SM) x {CHECK_LOOPS} steps equal to the plain "
                  f"version; events over 5 launches {p1_rows[name]['event_ms']:.4f} ms, plain "
                  f"{plain_ms_k:.1f} ms, index_select (the build, 16 steps) {library_ms:.4f} ms, bound "
                  f"{b['bound_ms']:.4f} ms ({b['busiest']}) on {card}", flush=True)
            print(f"[22 sass] P1 {name}: SASS per element-step "
                  f"{json.dumps({k: round(v, 3) for k, v in sass.items()})} ({steps:g} a trip); the "
                  f"bound's extract and update {json.dumps(roofline.COLUMN_STEP_OPS[t1])}", flush=True)
    counts, result = drive_probe("p1", p1.launches)
    for r in result["p1"]:
        numbers = p1_rows[r["name"]]
        # A 16-step launch's device time: its element-steps over the rate
        # differenced over steps inside one launch.
        numbers["ms"] = r["ms_per_16_steps"]
        sass = {k: round(v, 3) for k, v in numbers.pop("sass").items()}
        numbers["note"] = (f"ms: a {CHECK_LOOPS}-step launch of {numbers.pop('elements')} elements, "
                           f"differenced; events over 5 launches {numbers.pop('event_ms'):.4f} ms; "
                           f"bound by {numbers.pop('busiest')}; library_ms: index_select, the build "
                           f"alone, no extract; SASS per element-step {json.dumps(sass)}")
        print(f"[22 rate] P1 {r['name']}: {r['element_steps_per_s'] / 1e9:.2f} G element-steps/s, "
              f"a 16-step launch {r['ms_per_16_steps']:.5f} ms, {numbers['bound_ms'] / numbers['ms']:.1%} "
              f"of its bound {numbers['bound_ms']:.5f} ms ({r['bound_class']}); index_select "
              f"{r['library_element_steps_per_s'] / 1e9:.2f} G column builds/s on {card}", flush=True)
    for name, numbers in p1_rows.items():
        record(f"lut_columns_{name}", numbers.pop("kind"), "lut_columns.cu", counts.get(name, 0),
               **numbers)
    print(f"[22 launches] {json.dumps(counts)}", flush=True)


def probe_phases(dev, card: str, lap, builds: dict, copy_bw: float) -> list[dict]:
    """Phases 21-24: the probes P1-P4 built, held against their plain
    versions, timed, and run through their entry point. Returns their
    kernel records."""
    from informationbottleneckdecodingldpc_torch.kernels import bulk_copies as p4
    from informationbottleneckdecodingldpc_torch.kernels import bulk_read as p23
    from informationbottleneckdecodingldpc_torch.kernels import lut_columns as p1
    from informationbottleneckdecodingldpc_torch.utils import probes, roofline
    from informationbottleneckdecodingldpc_torch.utils.peaks import device_ms

    # -- 21: the probes' builds (started in phase 2) ------------------------------
    names = {p1.kernel_name(v, t): f"{v} T{t}" for v in p1.VARIANTS for t in p1.CONFIGS}
    names.update({"ring_kernelILi0E": "seq", "ring_kernelILi1E": "strided", "ring_kernelILi2E": "table",
                  "nested": "nested", "scatter": "scatter", "stage": "stage"})
    for name, b in builds.items():
        print(f"[21 build] {name}.cu: nvcc {b['seconds']:.2f} s (beside K1-K6); "
              f"{ptxas_lines(b['log'], names)}", flush=True)
    lap(21)
    records = []

    def record(name: str, kind: str, source: str, launches: int, **numbers) -> None:
        if not launches:
            raise AssertionError(f"the probe entry point launched no {name}")
        records.append({"name": name, "route": "cuda",
                        "source": f"informationbottleneckdecodingldpc_torch/csrc/{source}",
                        "replaces": PROBE_REPLACES[kind],
                        "launches": launches, **numbers})

    # -- 22: P1, column builds on CUDA cores and tensor cores --------------------------
    column_phase(dev, card, builds, record)
    lap(22)

    # -- 23: P2/P3, reads staged by bulk copies ------------------------------------------
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    src = probes.read_source(dev, seed=23)
    read_rows, library_ms_of = {}, {}  # variants that read the same bytes share their library call
    for variant, kb in dict.fromkeys(v for p in ("p2", "p3") for v in p23.PROBES[p]):
        probe = p23.BulkRead(variant, kb * 1024 // p23.ROW_BYTES)
        got = probe(src)
        want, plain_ms_k = timed_plain(lambda: probe.plain(src, sms))
        if not torch.equal(got, want):
            raise AssertionError(f"P2/P3 {probe.name} checksums disagree with the plain version")
        # The one PyTorch call over the same words: x.sum() for seq (the whole
        # source), the 7 planes' sum for the others, whose total is the
        # checksums' (wrapping).
        if variant == "seq":
            call, moved = (lambda: src.sum()), src.numel() * 4
        else:
            call, moved = probes.read_library(probe, src)
            if p23.wrap_int32(call()) != p23.wrap_int32(got.long().sum()):
                raise AssertionError(f"the 7 planes' sum is not {probe.name}'s wrapping total")
        if moved not in library_ms_of:
            library_ms_of[moved] = cuda_ms(call, reps=5)
        b = roofline.bound(probe.bytes_per_pass + 4 * sms, {})
        read_rows[probe.name] = dict(
            kind=variant, max_abs_err=0, event_ms=cuda_ms(lambda: probe(src), reps=5),
            plain_ms=plain_ms_k, library_ms=library_ms_of[moved],
            bound_ms=b["bound_ms"], bound_by=b["bound_by"], slots=probe.slots(),
            bytes_in_flight_per_sm=probe.bytes_in_flight_per_sm(),
        )
        line = (f"[23 exact] {probe.name}: {probe.units} copies of {kb} KB on {sms} blocks, "
                f"{probe.slots()} slots a block, {probe.bytes_in_flight_per_sm() // 1024} KB in "
                f"flight per SM, checksums equal to the plain version; kernel "
                f"{read_rows[probe.name]['event_ms']:.4f} ms (events over 5 calls)")
        if variant != "nested":  # the ring at two blocks per SM, each with half the bytes
            got2 = probe(src, blocks=2 * sms)
            if not torch.equal(got2, probe.plain(src, 2 * sms)):
                raise AssertionError(f"P2/P3 {probe.name} on {2 * sms} blocks disagrees with the plain "
                                     "version")
            read_rows[probe.name]["event_ms_2_per_sm"] = cuda_ms(lambda: probe(src, blocks=2 * sms),
                                                                  reps=5)
            line += (f", at 2 blocks per SM ({probe.slots(2)} slots each, equal) "
                     f"{read_rows[probe.name]['event_ms_2_per_sm']:.4f} ms")
        print(f"{line}; {'x.sum()' if variant == 'seq' else 'the planes sum'} "
              f"{read_rows[probe.name]['library_ms']:.4f} ms, plain {plain_ms_k:.1f} ms, bound "
              f"{b['bound_ms']:.4f} ms on {card}", flush=True)
    del src, got, want, got2
    torch.cuda.empty_cache()
    counts, result = drive_probe("p2,p3", p23.launches)
    for r in result["reads"]["variants"]:
        numbers = read_rows[r["name"]]
        # A pass's device time: its bytes over the rate differenced over
        # passes inside one launch.
        numbers["ms"] = r["ms_per_pass"]
        numbers["note"] = (f"ms: a pass, differenced; events over 5 calls {numbers['event_ms']:.4f} ms; "
                           f"{numbers['slots']} slots, {numbers['bytes_in_flight_per_sm'] // 1024} KB "
                           "in flight per SM")
        if "event_ms_2_per_sm" in numbers:
            numbers["note"] += f"; 2 blocks per SM {numbers['event_ms_2_per_sm']:.4f} ms (events)"
        print(f"[23 rate] {r['name']}: {r['bytes_per_s'] / 1e9:.1f} GB/s read, "
              f"{r['bytes_per_s'] / roofline.DATA_SHEET_BYTES_PER_S:.1%} of 3.35 TB/s, "
              f"{r['bytes_per_s'] / copy_bw:.1%} of copy_'s {copy_bw / 1e9:.1f} GB/s; a pass "
              f"{r['ms_per_pass']:.4f} ms (events over 5 calls {numbers['event_ms']:.4f}), "
              f"{numbers['bound_ms'] / r['ms_per_pass']:.1%} of its bound on {card}", flush=True)
    for name, numbers in read_rows.items():
        record(f"bulk_read_{name}", numbers.pop("kind"), "bulk_read.cu", counts.get(name, 0), **numbers)
    lap(23)

    # -- 24: P4, bulk copies and waits ----------------------------------------------------
    import numpy as np

    copy_rows, library_ms_of = {}, {}  # variants with the same copies share their library call's time
    for v in probes.copy_variants(sms):
        operands = probes.copy_operands(v, dev, seed=24)
        if v.direction == "scatter":
            image, target = operands
            want = torch.zeros_like(target)
            v.scatter(image, target, waves=2)
            _, plain_ms_k = timed_plain(lambda: p4.scatter_plain(image, want, v.copy_dst, v.copy_smem,
                                                                 v.copy_rows))
            same = torch.equal(target, want)
            ms = device_ms(lambda: v.scatter(image, target, waves=1))
            # The image rows the wave reads, once each, and the rows it writes.
            moved = (len(np.unique(v.copy_smem)) + v.copies) * v.copy_bytes
        else:
            (source,) = operands
            got = v.stage(source, waves=2)
            want, plain_ms_k = timed_plain(lambda: p4.stage_plain(source, v.copy_dst, v.copy_smem,
                                                                  v.copy_rows, v.blocks))
            same = torch.equal(got, want)
            ms = device_ms(lambda: v.stage(source, waves=1))
            moved = v.copies * v.copy_bytes + 4 * v.blocks
        if not same:
            raise AssertionError(f"P4 {v.name} disagrees with its plain version")
        key = (v.direction, v.copy_rows, v.regions)
        if key not in library_ms_of:
            library_ms_of[key] = device_ms(probes.copy_library(v, operands, dev)[0])
        library_ms = library_ms_of[key]
        b = roofline.bound(moved, {})
        copy_rows[v.name] = dict(kind="copies" if v.entries >= v.wave else "copies_per_wait",
                                 max_abs_err=0, ms=ms, plain_ms=plain_ms_k, library_ms=library_ms,
                                 bound_ms=b["bound_ms"], bound_by=b["bound_by"])
        if v.blocks == 1:
            copy_rows[v.name]["note"] = "one block: one SM's issue cost"
        deal = ("the card-wide wave" if v.regions == 1 and v.blocks > 1 else
                "one block" if v.blocks == 1 else f"a wave on each of {v.blocks} blocks")
        library = "index_copy_" if v.direction == "scatter" else "index_select + sum"
        print(f"[24 exact] {v.name}, {deal}: {v.copies} copies of {v.copy_bytes} B on {v.blocks} "
              f"blocks x {p4.WARPS} issuing warps, at most {v.group} a wait, "
              f"{'destination' if v.direction == 'scatter' else 'checksums'} equal to the plain "
              f"version; one wave {ms:.4f} ms (device), {library} {library_ms:.4f} ms "
              f"({library_ms / ms:.2f} x the kernel's time), plain {plain_ms_k:.1f} ms, bound "
              f"{b['bound_ms']:.4f} ms on {card}", flush=True)
        del operands, want
        torch.cuda.empty_cache()
    counts, result = drive_probe("p4", p4.launches)
    for r in result["p4"]:
        print(f"[24 rate] {r['name']}: {r['us_per_copy']:.4f} us per copy, {r['us_per_wait']:.4f} us "
              f"per wait ({r['waits_per_wave']} waits of one warp a wave), one wave "
              f"{r['us_per_copy'] * r['copies']:.2f} us against the library call's "
              f"{r['library_us_per_wave']:.2f} us (differenced) on {card}", flush=True)
    for name, numbers in copy_rows.items():
        record(f"bulk_copies_{name}", numbers.pop("kind"), "bulk_copies.cu", counts.get(name, 0),
               **numbers)
    print(f"[24 launches] {json.dumps(counts)}", flush=True)
    lap(24)
    return records


def channel_input_phase(dev, card: str, box_muller: dict[str, float], main_counts, record) -> None:
    """Phase 26: every fused kind of the channel-input kernel and every plane
    equal (``==``) to its plain version on the card at the cells' shapes
    (:data:`CHANNEL_INPUT_CASES`, :data:`PHILOX_PLANES`) and on ragged ones,
    each timed (device time) beside its bound, a fill of its output and,
    for a fused kind, the parent's composition (the plane kernel, then the
    torch operators); the records through ``record`` with the launches of
    the main path's phases ``main_counts``. ``box_muller`` holds one
    normal's SASS instructions by type (phase 25)."""
    import numpy as np

    from informationbottleneckdecodingldpc_torch.channel import (
        build_quantizer_tables, device_tables, sigma2_from_ebn0_db)
    from informationbottleneckdecodingldpc_torch.kernels import philox_planes
    from informationbottleneckdecodingldpc_torch.sim import rng
    from informationbottleneckdecodingldpc_torch.utils import roofline
    from informationbottleneckdecodingldpc_torch.utils.peaks import device_ms

    key = rng.key_words(0x0123456789ABCDEF)

    def kernel_bound(kind: str, out: torch.Tensor, moved: int, thresholds: int = 0) -> dict:
        """Bytes moved, and the operations the output needs per type."""
        rows, batch = out.shape
        return roofline.bound(moved, roofline.channel_input_ops(kind, rows, batch, box_muller,
                                                                thresholds))

    for label, kind, rows, batch, t, ebn0, offset, recorded in CHANNEL_INPUT_CASES:
        sigma2 = float(np.float32(sigma2_from_ebn0_db(ebn0, 0.5)))
        qt = device_tables(build_quantizer_tables(sigma2, 3.0, t, 2000), dev)
        codeword = None
        if philox_planes.FUSED[kind][2]:
            g = torch.Generator(device=dev)
            g.manual_seed(rows + batch)
            codeword = torch.randint(0, 2, (rows, batch), generator=g, device=dev, dtype=torch.int8)
        run = lambda: rng.channel_input(kind, key, rows, offset, batch, dev, qt, sigma2, codeword)
        compose = lambda: rng.consume(
            kind, rng.draw(philox_planes.draw_of(kind), key, rows, offset, batch, dev), qt, sigma2,
            codeword)
        got = run()
        want, plain_ms_k = timed_plain(lambda: rng.channel_input_plain(
            kind, key, rows, offset, batch, qt, sigma2, codeword, dev))
        if not (torch.equal(got, want) and torch.equal(compose(), got)):
            raise AssertionError(f"channel input {kind} ({label}) disagrees with its plain version in "
                                 f"{int((got != want).sum())} elements")
        moved = got.numel() * got.element_size() + (0 if codeword is None else codeword.numel())
        b = kernel_bound(kind, got, moved, t - 1)
        ms, composed_ms, fill_ms = device_ms(run), device_ms(compose), device_ms(lambda: got.fill_(0))
        print(f"[26 exact] {label}: {kind} {rows} x {batch}, |T|={t}, {ebn0} dB, codewords from "
              f"{offset}, equal to the plain version and to the composition; kernel {ms:.4f} ms, "
              f"composition (plane kernel, then torch operators) {composed_ms:.4f} ms, plain "
              f"{plain_ms_k:.1f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']}: bytes "
              f"{b['io_ms']:.4f}, operations {b['compute_ms']:.4f}), fill_ of the output "
              f"{fill_ms:.4f} ms on {card}", flush=True)
        if recorded:
            record(f"channel_input_{kind}", CHANNEL_INPUT_REPLACES[kind], main_counts[kind], ms=ms,
                   plain_ms=plain_ms_k, bound_ms=b["bound_ms"], bound_by=b["bound_by"])
    for kind, (rows, batch) in PHILOX_PLANES.items():
        run = lambda: rng.draw(kind, key, rows, 0, batch, dev)
        got = run()
        want, plain_ms_k = timed_plain(lambda: rng.plane_plain(kind, key, rows, 0, batch, dev))
        ragged = rng.draw(kind, key, rows - 1, 77, 1001, dev)
        if not (torch.equal(got, want) and torch.equal(ragged, rng.plane_plain(kind, key, rows - 1, 77, 1001, dev))):
            raise AssertionError(f"the Philox {kind} plane disagrees with its plain version")
        b = kernel_bound(kind, got, got.numel() * got.element_size())
        ms, fill_ms = device_ms(run), device_ms(lambda: got.fill_(0))
        print(f"[26 exact] Philox {kind} plane {rows} x {batch} (and {rows - 1} x 1001 from codeword "
              f"77) equal to the plain version: kernel {ms:.4f} ms, plain {plain_ms_k:.1f} ms, bound "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']}: bytes {b['io_ms']:.4f}, operations "
              f"{b['compute_ms']:.4f}), fill_ of the output {fill_ms:.4f} ms on {card}", flush=True)
        note = None if kind == "bits" else ("off the main path: every step's channel input draws "
                                            "its plane in registers (channel_input_*)")
        record(f"philox_planes_{kind}", CHANNEL_INPUT_REPLACES[kind], main_counts[kind], note=note,
               ms=ms, plain_ms=plain_ms_k, bound_ms=b["bound_ms"], bound_by=b["bound_by"])
    print(f"[26 launches] main path (phases 4, 9, 14): {json.dumps(dict(main_counts))}", flush=True)


def late_phases(dev, card: str, lap, builds: dict, main_counts, k3_ms_per_body: float,
                dv_layout) -> list[dict]:
    """Phases 25-29: the channel-input kernel, P5 and P6 built, held against
    their plain versions, timed, and P5/P6 run through the probe entry point.
    ``main_counts`` holds the Philox kernel's launches per kind in the main
    path's phases. Returns their kernel records."""
    from informationbottleneckdecodingldpc_torch.kernels import stage_chunks as p5
    from informationbottleneckdecodingldpc_torch.kernels import stage_replay as p6
    from informationbottleneckdecodingldpc_torch.utils import probes, roofline

    # -- 25: the builds (started in phase 2) -------------------------------------------
    names = {**{v[len("channel_input_kernel"):-2] + f"{vec}E": k + ("" if vec else " scalar stores")
                for k, v in CHANNEL_INPUT_KERNELS.items() for vec in (0, 1)},
             **{f"stage_kernelILi{k}E": v for k, v in enumerate(("base", "dynsem", "pipeline", "vwrite"))},
             **{f"{p}_kernelILb{hi}ELb{out}E": f"{p}{' high' if hi else ''}{'' if out else ' nowrite'}"
                for p in ("cn", "vn") for hi in (0, 1) for out in (0, 1)},
             "staged_kernelILb0E": "cn staged", "staged_kernelILb1E": "vn staged"}
    for name, b in builds.items():
        print(f"[25 build] {name}.cu: nvcc {b['seconds']:.2f} s (beside K1-K6, P1-P4); "
              f"{ptxas_lines(b['log'], names)}", flush=True)
    functions = sass_functions(builds["philox_planes"]["path"])
    for kind, mangled in CHANNEL_INPUT_KERNELS.items():
        ops = common_path_counts(next(v for k, v in functions.items() if mangled in k))
        counts = roofline.pipe_counts(ops)
        print(f"[25 sass] channel input {kind}, one thread trip (4 codeword columns of one group "
              f"row): {sum(ops.values())} instructions, {json.dumps(counts)}", flush=True)
        if kind == "normal":  # 8 normals a trip: Box-Muller's libdevice work per normal
            box_muller = {k: n / 8 for k, n in counts.items() if n}
    lap(25)
    records = []

    def record(name: str, replaces: str, launches: int, source: str = "philox_planes.cu",
               note: str | None = None, **numbers) -> None:
        if not launches and note is None:
            raise AssertionError(f"the main path launched no {name}")
        records.append({"name": name, "route": "cuda",
                        "source": f"informationbottleneckdecodingldpc_torch/csrc/{source}",
                        "replaces": replaces, "launches": launches, "max_abs_err": 0,
                        "library_ms": None, **numbers, **({"note": note} if note else {})})

    # -- 26: the channel-input kernel ----------------------------------------------------
    channel_input_phase(dev, card, box_muller, main_counts, record)
    lap(26)

    # -- 27: P5, the staged 7-plane skeleton ---------------------------------------------
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    src = probes.read_source(dev, seed=27, rows=p5.HBM_ROWS)
    p5_rows = {}
    for variant in p5.VARIANTS:
        probe = p5.StageChunks(variant)
        got = probe(src, iters=2)
        want, plain_ms_k = timed_plain(lambda: probe.plain(src, sms, iters=1))
        if not torch.equal(got, probe.plain(src, sms, iters=2)):
            raise AssertionError(f"P5 {variant} checksums disagree with the plain version")
        b = roofline.bound(probe.bytes_per_iteration + 4 * sms, {})
        p5_rows[variant] = dict(ms=cuda_ms(lambda: probe(src, iters=1), reps=5), plain_ms=plain_ms_k,
                                bound_ms=b["bound_ms"], bound_by=b["bound_by"])
        print(f"[27 exact] P5 {variant}: {probe.units} piece-chunks of 7 x {probe.piece_rows} rows "
              f"on {sms} blocks, checksums equal to the plain version; one iteration "
              f"{p5_rows[variant]['ms']:.4f} ms, plain {plain_ms_k:.1f} ms, bound "
              f"{b['bound_ms']:.4f} ms on {card}", flush=True)
    del src, got, want
    torch.cuda.empty_cache()
    lap(27)

    # -- 28: P6, K3's pass program with the folds replaced ---------------------------------
    base = p6.ReplayViews.random(dv_layout, probes.REPLAY_BATCH, dev, seed=28)
    scratch = base.clone()
    p6_rows = {}
    for variant in p6.VARIANTS:
        probe = p6.StageReplay(dv_layout, variant)
        got, want = base.clone(), base.clone()
        probe(got, bodies=2)
        probe.plain(want, bodies=2)
        _, plain_ms_k = timed_plain(lambda: probe.plain(scratch, bodies=1))
        if not got.equal(want):
            raise AssertionError(f"P6 {variant} disagrees with its plain version")
        moved = probe.bytes_per_body(probes.REPLAY_BATCH)
        b = roofline.bound(moved, {})
        p6_rows[variant] = dict(ms=cuda_ms(lambda: probe(got, bodies=1), reps=5), plain_ms=plain_ms_k,
                                bound_ms=b["bound_ms"], bound_by=b["bound_by"])
        print(f"[28 exact] P6 {variant} (TPU {p6.TPU_VARIANT[variant]}): views and checksums after 2 "
              f"bodies equal to the plain version; one body {p6_rows[variant]['ms']:.4f} ms, plain "
              f"{plain_ms_k:.1f} ms, bound {b['bound_ms']:.4f} ms ({moved / 1e6:.0f} MB, "
              f"{b['bound_ms'] / p6_rows[variant]['ms']:.1%} of it), K3 {k3_ms_per_body:.4f} ms per "
              f"body (phase 15) on {card}", flush=True)
        del got, want
    del base, scratch
    torch.cuda.empty_cache()
    lap(28)

    # -- 29: the entry point's P5 and P6 -------------------------------------------------
    p5_counts, p6_counts, result = drive_probe("p5,p6", p5.launches, p6.launches)
    for r in result["p5"]:
        print(f"[29 rate] P5 {r['name']}: {r['ms_per_iteration']:.4f} ms per iteration, "
              f"{r['bytes_per_s'] / 1e9:.1f} GB/s staged, {r['bound_ms'] / r['ms_per_iteration']:.1%} "
              f"of the bound on {card}", flush=True)
    replay = result["p6"]
    for r in replay["variants"]:
        print(f"[29 rate] P6 {r['name']}: {r['ms_per_body']:.4f} ms per body, {r['bytes_per_s'] / 1e9:.1f} "
              f"GB/s of views, {r['bound_ms'] / r['ms_per_body']:.1%} of the view-traffic bound, "
              f"K3 {replay['k3_ms_per_body']:.4f} ms per body on {card}", flush=True)
    exact = next(r["ms_per_body"] for r in replay["variants"] if r["name"] == "exact")
    if replay["k3_view_bits"] == 8:
        folds = replay["k3_ms_per_body"] - exact
        print(f"[29 folds] K3's body {replay['k3_ms_per_body']:.4f} ms less P6 exact's {exact:.4f} ms "
              f"(its memory pattern without the folds): the folds' share {folds:.4f} ms, "
              f"{folds / replay['k3_ms_per_body']:.1%} of K3's body on {card}", flush=True)
    else:  # P6 replays byte views: its difference to a packed K3 is not the folds'
        print(f"[29 folds] not taken: K3 ran {replay['k3_view_bits']}-bit views "
              f"({replay['k3_ms_per_body']:.4f} ms a body), P6 exact replays bytes ({exact:.4f} ms) "
              f"on {card}", flush=True)

    for variant, numbers in p5_rows.items():
        record(f"stage_chunks_{variant}", "scripts/stage_probe.py:41", p5_counts.get(variant, 0),
               source="stage_chunks.cu", **numbers)
    for variant, numbers in p6_rows.items():
        record(f"stage_replay_{variant}", "scripts/stage_replay.py:61", p6_counts.get(variant, 0),
               source="stage_replay.cu", **numbers)
    print(f"[29 launches] P5 {json.dumps(p5_counts)}; P6 {json.dumps(p6_counts)}", flush=True)
    lap(29)
    return records


def mary_phases(dev, card: str, lap, layout, encoder, dv_layout, dv_encoder) -> dict:
    """Phases 30-34: the M-ary chains (QAM and M-PSK through the exact soft
    demapper into K2, or K4 on DVB-S2) and the resumable sweep on the card.
    Returns the launches of the M-ary main path (phases 31-32) per kernel and
    the profile of phase 33."""
    import numpy as np

    from informationbottleneckdecodingldpc_torch.channel import (
        gray_encoding_table, mpsk_bit_llrs, mpsk_map, qam_bit_llrs, qam_map, sigma2_from_ebn0_db)
    from informationbottleneckdecodingldpc_torch.channel.demap import demap_llrs
    from informationbottleneckdecodingldpc_torch.channel.modulation import Constellation
    from informationbottleneckdecodingldpc_torch.cli import simulate
    from informationbottleneckdecodingldpc_torch.kernels import FusedFloatDecoder, float_decode_tiled
    from informationbottleneckdecodingldpc_torch.kernels import philox_planes
    from informationbottleneckdecodingldpc_torch.sim import BERSimulator, PointCheckpoint, rng
    from informationbottleneckdecodingldpc_torch.sim.engine import step_seed
    from informationbottleneckdecodingldpc_torch.sim.results import load_partial, save_results
    from informationbottleneckdecodingldpc_torch.utils.benchmarks import measure_sim_throughput
    from informationbottleneckdecodingldpc_torch.utils.peaks import device_ms

    cpu = torch.device("cpu")
    f32 = np.float32

    # -- 30: map and demap on the card against the CPU ------------------------------------
    ref_sigma2 = float(f32(sigma2_from_ebn0_db(3.5, 0.5)))
    g = np.random.default_rng(30)
    qam16_llrs = None
    for kind, order, label in (("qam", 4, "QAM-16"), ("qam", 8, "QAM-64"), ("mpsk", 8, "8-PSK")):
        k = 2 * int(np.log2(order)) if kind == "qam" else int(np.log2(order))
        table = gray_encoding_table(k // 2 if kind == "qam" else k)
        bits = g.integers(0, 2, (layout.n_vars, MARY_BATCH)).astype(np.int8)
        noise = g.normal(size=(layout.n_vars // k, MARY_BATCH, 2)).astype(np.float32)
        n0 = float(f32(f32(2.0) * f32(ref_sigma2)) / f32(k))
        scale = float(f32(math.sqrt(n0 / 2.0)))
        mapper, demapper = (qam_map, qam_bit_llrs) if kind == "qam" else (mpsk_map, mpsk_bit_llrs)
        out = []
        for d in (cpu, dev):
            sym = mapper(torch.as_tensor(bits, device=d), table, order)
            y = sym + scale * torch.as_tensor(noise, device=d)
            out.append((sym, y, demapper(y, table, order, n0)))
        (sym_c, y_c, llr_c), (sym_g, y_g, llr_g) = out
        if not (torch.equal(sym_g.cpu(), sym_c) and torch.equal(y_g.cpu(), y_c)):
            raise AssertionError(f"{label}: the card's symbols or received values differ from the CPU's")
        want = llr_c.numpy()
        err = np.abs(llr_g.cpu().numpy() - want) / np.maximum(1.0, np.abs(want))
        if not err.max() <= MARY_LLR_RTOL:
            raise AssertionError(f"{label}: the card's LLRs differ from the CPU's by {err.max():.3e} "
                                 f"of max(1, |ref|), above {MARY_LLR_RTOL}")
        # A few calls: each launches tens of small kernels, and more than the
        # launch queue holds would wait on the sleep device_ms queues them behind.
        # The tables are made on the card first, as the simulator makes them.
        constellation = Constellation.build(kind, order, table, dev)
        demap_ms = device_ms(lambda: demap_llrs(constellation, y_g, n0), reps=4)
        print(f"[30 exact] {label} on WLAN, {layout.n_vars} bits x {MARY_BATCH}, n0 {n0:.6f}: symbols "
              f"and received values equal to the CPU's, LLRs within {err.max():.3e} of max(1, |ref|) "
              f"(tolerance {MARY_LLR_RTOL}, {float((err == 0).mean()):.4f} of them equal); demap "
              f"{demap_ms:.4f} ms on {card}", flush=True)
        if label == "QAM-16":
            qam16_llrs = llr_g
    dec = FusedFloatDecoder(layout, "minsum", max_iters=50)
    got = dec(qam16_llrs)
    ref = float_decode_tiled(layout, qam16_llrs, "minsum", dec.batch_tile, 50)
    torch.cuda.synchronize()
    if not (bool((got.outputs == ref.outputs).all()) and torch.equal(got.unsatisfied, ref.unsatisfied)
            and float(got.iterations) == float(ref.iterations)):
        raise AssertionError("K2 disagrees with its twin on the card's QAM-16 LLRs")
    print(f"[30 exact] K2 min-sum on the card's QAM-16 LLRs at 3.5 dB, batch {MARY_BATCH}: outputs, "
          f"unsatisfied and mean iterations {float(got.iterations):.4f} equal to the plain twin",
          flush=True)
    lap(30)

    # -- 31: the WLAN min-sum QAM-16 chain (scripts/queue.py wlan_minsum_qam16) -----------
    ref_file = Path(__file__).resolve().parent / "results/ber/wlan_minsum_qam16.json"
    reference = {p["ebn0_db"]: p for p in json.loads(ref_file.read_text())["points"]}
    launched = collections.Counter()

    def mary_sim(lay, enc, kind, order, batch, steps, seed):
        return BERSimulator(lay, "minsum", device=dev, max_iters=50, chain="encoded",
                            llr_source="true", modulation=kind, mod_order=order, encoder=enc,
                            batch_per_device=batch, steps_per_dispatch=steps, seed=seed)

    def drive(sim, points, name):
        """Throughput at the first point and ``MARY_DISPATCHES`` dispatches at
        each, with the launches counted from 0: one bits and one normal plane
        and one decode a step, no fused channel input."""
        decoder = sim.fused_decoder
        decoder.launches = 0
        philox_planes.launches.clear()
        rate = measure_sim_throughput(sim, points[0])
        got = {db: dispatch_point(sim, db, MARY_DISPATCHES) for db in points}
        steps = (1 + 6 + MARY_DISPATCHES * len(points)) * sim.steps_per_dispatch
        planes = collections.Counter(philox_planes.launches)
        if decoder.launches != steps or planes != collections.Counter(bits=steps, normal=steps):
            raise AssertionError(f"{name}: {decoder.launches} decodes and Philox launches "
                                 f"{dict(planes)} for {steps} steps")
        if sim.channel_input_kind is not None:
            raise AssertionError(f"{name} names the fused kind {sim.channel_input_kind}")
        launched.update(planes)
        launched["k2" if sim.backend == "fused" else "k4"] += decoder.launches
        print(f"[{name}] {rate / 1e6:.2f} Mbit/s coded on {card} ({sim.backend}, batch "
              f"{sim.batch_total} x {sim.steps_per_dispatch} steps); {decoder.launches} decodes, "
              f"{planes['bits']} bits and {planes['normal']} normal planes for {steps} steps, no "
              "fused channel input", flush=True)
        return rate, got

    qam = mary_sim(layout, encoder, "qam", 4, MARY_BATCH, 8, 33)
    qam_rate, qam_points = drive(qam, (3.5, 4.2), "31 chain")
    for db, point in qam_points.items():
        r = reference[db]
        fer_band, ber_band = ref_bands(point, r["fer"], r["blocks"])
        print(f"[31 point] QAM-16 {db} dB over {point['blocks']} blocks: FER {point['fer']:.5f} "
              f"({r['fer']} +- {fer_band:.5f}), BER {point['ber']:.6f} ({r['ber']:.6f} +- "
              f"{ber_band:.6f}, results/ber/wlan_minsum_qam16.json, {r['blocks']} blocks), mean "
              f"iterations {point['iterations']:.3f}", flush=True)
        if abs(point["fer"] - r["fer"]) > fer_band or abs(point["ber"] - r["ber"]) > ber_band:
            raise AssertionError(f"QAM-16 FER or BER at {db} dB outside its band")
    # One dispatch's counters, and the planes it draws held against their
    # plain version on the card: equal planes feed the same demap and K2. The
    # CPU's plain normals differ from the card's in the last bits of some
    # elements (libm against libdevice), which a 49-body min-sum decode of
    # 4096 codewords turns into other counts: the elements are counted here.
    counters = [float(v) for v in qam._step(3.5, 0, None)]
    rows = 2 * layout.n_vars // 4
    for j in range(qam.steps_per_dispatch):
        key = rng.key_words(step_seed(qam.seed, 3.5, j))
        for kind, n in (("bits", qam._info_len), ("normal", rows)):
            if not torch.equal(rng.draw(kind, key, n, 0, MARY_BATCH, dev),
                               rng.plane_plain(kind, key, n, 0, MARY_BATCH, dev)):
                raise AssertionError(f"step {j}'s {kind} plane differs from its plain version")
    card_noise = rng.draw("normal", qam._key, rows, 0, MARY_BATCH, dev).cpu()
    differ = int((card_noise != rng.plane_plain("normal", qam._key, rows, 0, MARY_BATCH)).sum())
    print(f"[31 counters] one QAM-16 dispatch at 3.5 dB: bit errors {counters[0]:.0f}, frame errors "
          f"{counters[1]:.0f}, mean iterations {counters[2]:.4f}; the bits and normal planes of its "
          f"{qam.steps_per_dispatch} steps equal their plain version on the card; the CPU's plain "
          f"normal plane of its last step differs from the card's in {differ} of "
          f"{card_noise.numel()} elements (last bits)", flush=True)
    lap(31)

    # -- 32: the 8-PSK chain (scripts/queue.py wlan_minsum_psk8), and QAM-16 on DVB-S2 ----
    psk = mary_sim(layout, encoder, "mpsk", 8, MARY_BATCH, 8, 34)
    psk_rate, psk_points = drive(psk, PSK_POINTS, "32 chain")
    fers = [psk_points[db]["fer"] for db in PSK_POINTS]
    for db, point in psk_points.items():
        print(f"[32 point] 8-PSK {db} dB over {point['blocks']} blocks: FER {point['fer']:.5f}, BER "
              f"{point['ber']:.6f}, mean iterations {point['iterations']:.3f} (no reference curve)",
              flush=True)
    if not 0 < fers[1] < fers[0]:
        raise AssertionError(f"8-PSK FER does not fall with Eb/N0: {fers}")
    dv = mary_sim(dv_layout, dv_encoder, "qam", 4, 1024, 1, 0)
    if dv.backend != "hbm":
        raise AssertionError(f"DVB-S2 QAM-16 runs on {dv.backend!r}, not 'hbm'")
    dv_rate, dv_points = drive(dv, (3.0,), "32 dvbs2")
    print(f"[32 point] DVB-S2 QAM-16 through K4, 3.0 dB over {dv_points[3.0]['blocks']} blocks: FER "
          f"{dv_points[3.0]['fer']:.5f}, BER {dv_points[3.0]['ber']:.6f}", flush=True)
    del dv
    torch.cuda.empty_cache()
    lap(32)

    # -- 33: profile of one QAM-16 dispatch, in a process of its own -----------------------
    # (torch.profiler has seen no kernel in this process after earlier profiled phases.)
    child = subprocess.run([sys.executable, __file__, "--mary-profile", repr(qam_rate)],
                           capture_output=True, text=True, timeout=600)
    if child.returncode:
        raise AssertionError(f"the M-ary profile failed: {child.stderr[-3000:]}")
    profile_out = json.loads(child.stdout.strip().splitlines()[-1])
    per_step = profile_out["ms_per_step"]
    print(f"[33 profile] one QAM-16 dispatch (8 steps of {MARY_BATCH}) at 3.5 dB under "
          "torch.profiler: device ms per step " + ", ".join(f"{k} {v:.4f}" for k, v in per_step.items())
          + f"; wall {profile_out['wall_ms_per_step']:.4f} ms per step from phase 31's rate, idle "
          f"share {profile_out['idle_share']:.1%}, demap share {profile_out['demap_share']:.1%} "
          f"({profile_out['map_kernels']} map and {profile_out['demap_kernels']} demap kernels a "
          f"step) on {card}", flush=True)
    lap(33)

    # -- 34: resume on the card ------------------------------------------------------------
    spd = qam.steps_per_dispatch
    full = qam.run_point(3.5, min_errors=10**12, max_blocks=4 * MARY_BATCH * spd)
    snap = {}

    class Stop(Exception):
        pass

    def grab(state):
        snap.update(dataclasses.asdict(state))
        if state.step_index >= 2 * spd:
            raise Stop

    try:
        qam.run_point(3.5, min_errors=10**12, max_blocks=4 * MARY_BATCH * spd, on_progress=grab)
    except Stop:
        pass
    with tempfile.TemporaryDirectory() as tmp:
        save_results(str(Path(tmp) / "partial.json"), [], partial=snap)
        resumed = qam.run_point(3.5, min_errors=10**12, max_blocks=4 * MARY_BATCH * spd,
                                checkpoint=PointCheckpoint(**load_partial(str(Path(tmp) / "partial.json"))))
        keys = ("errors", "frame_errors", "blocks", "ber", "fer", "mean_iterations")
        if [getattr(resumed, k) for k in keys] != [getattr(full, k) for k in keys]:
            raise AssertionError(f"the resumed point counts {resumed}, the uninterrupted {full}")
        print(f"[34 resume] QAM-16 3.5 dB stopped after 2 dispatches and resumed from its saved "
              f"partial: {resumed.errors} bit errors, {resumed.frame_errors} frame errors over "
              f"{resumed.blocks} blocks, mean iterations {resumed.mean_iterations:.4f}, equal to the "
              "uninterrupted point", flush=True)
        out, npz = str(Path(tmp) / "psk8.json"), str(Path(tmp) / "psk8.npz")
        argv = ["--model", "wlan-1296", "--decoder", "minsum", "--chain", "encoded",
                "--modulation", "psk8", "--device", str(dev), "--start-db", str(PSK_POINTS[0]),
                "--step-db", "0.5", "--min-errors", "1", "--max-blocks-per-point", "4096",
                "--batch-per-device", str(MARY_BATCH), "--steps-per-dispatch", "8", "--seed", "34",
                "--results", out]
        first = simulate.main(argv + ["--max-db", str(PSK_POINTS[0] + 0.5)])
        second = simulate.main(argv + ["--max-db", str(PSK_POINTS[0] + 1.0), "--export-npz", npz])
        keys = set(np.load(npz).keys())
        if not (len(first) == 2 and second[:2] == first and len(second) == 3
                and keys == {"EbN0_dB_vector", "BER_vector", "FER_vector"}):
            raise AssertionError(f"the CLI's psk8 sweep did not resume: {first} then {second}, "
                                 f"npz keys {keys}")
        print(f"[34 cli] psk8 sweep through the CLI: points {[p['ebn0_db'] for p in first]} dB, "
              f"rerun with a higher --max-db resumed after them (both kept as saved, elapsed "
              f"{first[1]['elapsed_s']:.3f} s unchanged) and added {second[2]['ebn0_db']} dB (FER "
              f"{second[2]['fer']:.4f}); --export-npz keys {sorted(keys)}", flush=True)
    lap(34)
    return {"launches": launched, "profile": profile_out, "qam16_mbit_s": qam_rate / 1e6,
            "psk8_mbit_s": psk_rate / 1e6, "dvbs2_qam16_mbit_s": dv_rate / 1e6}


def mary_profile(bps: float) -> dict:
    """Phase 33, run in a process of its own: one dispatch of phase 31's
    QAM-16 simulator at 3.5 dB under ``torch.profiler``, its kernels in
    launch order attributed to the stages of each step (:func:`_attribute`);
    the map's and the demap's kernel counts come from the same trace, each
    run once alone between sleep kernels before the dispatch. ``bps`` is
    phase 31's rate, which gives the wall time per step and the idle share."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from informationbottleneckdecodingldpc_torch.channel.demap import demap_llrs
    from informationbottleneckdecodingldpc_torch.encode import LDPCEncoder
    from informationbottleneckdecodingldpc_torch.models import get_model
    from informationbottleneckdecodingldpc_torch.sim import BERSimulator, rng

    dev = torch.device("cuda")
    spec = get_model("wlan-1296")
    H = spec.make_h()
    layout = spec.make_layout(H)
    sim = BERSimulator(layout, "minsum", device=dev, max_iters=50, chain="encoded",
                       llr_source="true", modulation="qam", mod_order=4, encoder=LDPCEncoder(H),
                       batch_per_device=MARY_BATCH, steps_per_dispatch=8, seed=33)
    spd = sim.steps_per_dispatch
    sim._step(3.5, 9000 * spd, None)
    codeword = sim._encode(rng.draw("bits", sim._key, layout.data_len, 0, MARY_BATCH, dev))
    noise = rng.draw("normal", sim._key, 2 * layout.n_vars // 4, 0, MARY_BATCH, dev)
    n0 = sim.n0_for(sim.sigma2_for(3.5))
    scale = float(np.float32(math.sqrt(n0 / 2.0)))
    constellation = sim._constellation  # the step's own tables, on the card
    mapped = lambda: constellation.map(codeword) + scale * noise.view(
        -1, 2, MARY_BATCH).permute(0, 2, 1)
    y = mapped()
    demap_llrs(constellation, y, n0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(100_000)
        mapped()
        torch.cuda._sleep(100_000)
        demap_llrs(constellation, y, n0)
        torch.cuda._sleep(100_000)
        sim._step(3.5, 9001 * spd, None)
        torch.cuda.synchronize()
    trace = sorted(((e.name, e.time_range.start, e.time_range.elapsed_us())
                    for e in prof.events() if e.device_type == DeviceType.CUDA), key=lambda k: k[1])
    sleeps = [i for i, (n, _, _) in enumerate(trace) if "spin" in n or "sleep" in n]
    if len(sleeps) != 3:
        raise AssertionError(f"the profile holds {len(sleeps)} sleep kernels, not 3: "
                             f"{[n[:40] for n, _, _ in trace]}")
    n_map, n_demap = sleeps[1] - sleeps[0] - 1, sleeps[2] - sleeps[1] - 1
    stages = ("bits plane", "encoder", "normal plane", "map", "demap", "K2", "counting")
    ms = dict.fromkeys(stages, 0.0)
    steps, current = 0, []
    for name, _, us in trace[sleeps[2] + 1 :]:
        if DRAW_KERNEL in name and sum(
                DRAW_KERNEL in n for n, _ in current) == 2:
            steps += _attribute(current, n_map, n_demap, ms)
            current = []
        current.append((name, us))
    steps += _attribute(current, n_map, n_demap, ms)
    if steps != spd:
        raise AssertionError(f"the profile holds {steps} steps, not {spd}")
    wall = layout.n_vars * MARY_BATCH / bps * 1e3  # per step
    per_step = {k: v / 1e3 / spd for k, v in ms.items()}
    return {"ms_per_step": per_step, "wall_ms_per_step": wall,
            "idle_share": 1 - sum(per_step.values()) / wall, "demap_share": per_step["demap"] / wall,
            "map_kernels": n_map, "demap_kernels": n_demap}


def _attribute(kernels: list[tuple[str, float]], n_map: int, n_demap: int, ms: dict) -> int:
    """Add one M-ary step's kernels (name, us), in launch order, to the
    stages of ``ms``: the bits plane (the first Philox launch), the encoder
    (up to the second), the normal plane, ``n_map`` map kernels, ``n_demap``
    demap kernels, the decode, then the counting. Returns 1, or 0 for an
    empty list."""
    if not kernels:
        return 0
    draws = [i for i, (n, _) in enumerate(kernels) if DRAW_KERNEL in n]
    decode = [i for i, (n, _) in enumerate(kernels) if any(k in n for k in DECODE_KERNELS)]
    if len(draws) != 2 or len(decode) != 1 or decode[0] - draws[1] - 1 < n_map + n_demap:
        raise AssertionError(f"an M-ary step's kernels do not follow bits, encoder, normal, "
                             f"{n_map} map, {n_demap} demap, decode: {[n[:40] for n, _ in kernels]}")
    b, nrm, k = draws[0], draws[1], decode[0]
    m, d = nrm + 1 + n_map, nrm + 1 + n_map + n_demap
    spans = {"bits plane": (b, b + 1), "encoder": (b + 1, nrm), "normal plane": (nrm, nrm + 1),
             "map": (nrm + 1, m), "demap": (m, d), "K2": (d, k + 1), "counting": (k + 1, len(kernels))}
    for stage, (lo, hi) in spans.items():
        ms[stage] += sum(us for _, us in kernels[lo:hi])
    return 1


# Phases 35-38's settings.
RANK_TIMEOUT = 600  # seconds for all ranks of one launch
PAIR_XLA_DB = 2.4  # WLAN min-sum, 256 codewords a rank x 4 steps: the halves alone leave
# after other bodies than the whole batch, and one step leaves none early (CPU run)
CLI_SWEEP = ["--model", "regular-3-6-504", "--decoder", "minsum", "--chain", "allzero",
             "--start-db", "3.0", "--min-errors", "5", "--max-iters", "4",
             "--max-blocks-per-point", "64"]  # tests/test_sim.py:257-335's sweep


def rank_main(argv: list[str]) -> None:
    """Phases 35-37, one rank of a process group on card 0, started by
    ``torch.distributed.run`` (``python3 chip_smoke.py --rank
    nccl|gloo-pair|cli ...``). ``nccl``: the headline through
    ``n_devices=1`` under a one-rank NCCL group, one dispatch from step 0 and
    its rate. ``gloo-pair``: this rank's shard of one dispatch of the
    headline (4096 a rank), DVB-S2 min-sum (K4, 1024 a rank) and WLAN
    min-sum on ``backend='xla'`` (256 a rank, early exit on). Both take a
    directory and write ``rank<r>.json`` there: the rank, the all-reduced
    counters and this rank's launches (a file, as the ranks' shared standard
    output may interleave their lines). ``cli <rank 0's results> <other
    ranks' results> <CLI args>``: the sweep CLI with ``--multihost`` over
    gloo on card 0."""
    import argparse
    import os

    from informationbottleneckdecodingldpc_torch.kernels import philox_planes
    from informationbottleneckdecodingldpc_torch.models import get_model
    from informationbottleneckdecodingldpc_torch.parallel import initialize_multihost
    from informationbottleneckdecodingldpc_torch.sim import BERSimulator
    from informationbottleneckdecodingldpc_torch.utils.benchmarks import (
        build_headline_sim, build_matrix_sim, measure_sim_throughput)

    p = argparse.ArgumentParser()
    p.add_argument("job", choices=["nccl", "gloo-pair", "cli"])
    p.add_argument("args", nargs=argparse.REMAINDER)
    a = p.parse_args(argv)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    if a.job == "cli":
        from informationbottleneckdecodingldpc_torch.cli import simulate

        results = a.args[0] if os.environ["RANK"] == "0" else a.args[1]
        simulate.main([*a.args[2:], "--results", results, "--device", str(dev),
                       "--dist-backend", "gloo", "--multihost"])
        return
    rank, _ = initialize_multihost(backend="nccl" if a.job == "nccl" else "gloo")
    out = {"rank": rank, "backend": torch.distributed.get_backend(),
           "launches": collections.Counter()}

    def dispatch(name: str, sim, ebn0_db: float) -> None:
        out[name] = [float(v) for v in sim._step(ebn0_db, 0, sim.quantizer_for(ebn0_db))]
        out[f"{name}_decoder"] = type(sim.fused_decoder).__name__

    philox_planes.launches.clear()
    if a.job == "nccl":
        sim = build_headline_sim(dev)
        sim.fused_decoder.launches = 0
        dispatch("headline", sim, 0.8)
        out["mbit_s"] = measure_sim_throughput(sim, 0.8) / 1e6
        out["launches"]["k1"] = sim.fused_decoder.launches
    else:
        sims = {
            "headline": (build_headline_sim(dev, n_devices=None), 0.8),
            "dvbs2_minsum": (build_matrix_sim("dvbs2_minsum", dev, n_devices=None)[0], 1.0),
            "xla_minsum": (BERSimulator(
                get_model("wlan-1296").make_layout(), "minsum", device=dev, max_iters=50,
                backend="xla", batch_per_device=256, n_devices=None, seed=0,
                steps_per_dispatch=4), PAIR_XLA_DB),
        }
        for name, (sim, ebn0) in sims.items():
            if name != "xla_minsum":
                sim.fused_decoder.launches = 0
            dispatch(name, sim, ebn0)
        out["launches"]["k1"] = sims["headline"][0].fused_decoder.launches
        out["launches"]["k4"] = sims["dvbs2_minsum"][0].fused_decoder.launches
    out["launches"].update(philox_planes.launches)
    torch.cuda.synchronize()
    torch.distributed.destroy_process_group()
    (Path(a.args[0]) / f"rank{rank}.json").write_text(json.dumps(out))


def launch(world: int, *args: str) -> str:
    """The standard output of ``world`` ranks of ``python3 chip_smoke.py
    --rank <args>`` (``parallel.run_ranks``); any rank's failure raises."""
    from informationbottleneckdecodingldpc_torch.parallel import run_ranks

    return run_ranks(world, [__file__, "--rank", *args], RANK_TIMEOUT)


def parallel_phases(dev, card: str, lap, headline: dict, layout, dv_codes) -> collections.Counter:
    """Phases 35-38: data-parallel decoding over ``torch.distributed`` (one
    rank under NCCL; two ranks sharing the card over gloo, against one
    process at the global batch), the multi-process CLI's resume broadcast,
    the dry run, and the port's decoder construction rebuilding the
    committed configs on this host. ``headline`` holds phase 4's dispatch
    counters and rate, ``dv_codes`` the DVB-S2 code's (H, layout, encoder).
    Returns the ranks' launches per kernel (K1, K4 and the channel-input kinds)."""
    import os

    import numpy as np

    from informationbottleneckdecodingldpc_torch.cli import dryrun, simulate
    from informationbottleneckdecodingldpc_torch.decode import DeviceTrellis
    from informationbottleneckdecodingldpc_torch.sim import BERSimulator
    from informationbottleneckdecodingldpc_torch.utils.benchmarks import (
        COMMITTED_CONFIGS, CONFIG_DIR, build_headline_sim, build_matrix_sim,
        rebuild_committed_config)

    # The ranks import the package from this checkout, wherever they start.
    root = str(Path(__file__).resolve().parent)
    os.environ["PYTHONPATH"] = os.pathsep.join(filter(None, [root, os.environ.get("PYTHONPATH")]))
    launched = collections.Counter()

    def rank_outputs(job: str, world: int) -> list[dict]:
        """Each rank's JSON file, in rank order."""
        with tempfile.TemporaryDirectory() as tmp:
            launch(world, job, tmp)
            files = [Path(tmp) / f"rank{r}.json" for r in range(world)]
            missing = [f.name for f in files if not f.exists()]
            if missing:
                raise AssertionError(f"{job}: no {missing} from {world} rank(s)")
            outs = [json.loads(f.read_text()) for f in files]
        if [o["rank"] for o in outs] != list(range(world)):
            raise AssertionError(f"{job}: ranks {[o['rank'] for o in outs]} reported, not {world}")
        for o in outs:
            launched.update(o["launches"])
        return outs

    # -- 35: the NCCL path at world size 1 ---------------------------------------------
    (one,) = rank_outputs("nccl", 1)
    if one["backend"] != "nccl" or one["headline_decoder"] != "FusedIBDecoder":
        raise AssertionError(f"phase 35 ran {one['headline_decoder']} over {one['backend']}")
    if one["headline"] != headline["dispatch"]:
        raise AssertionError(f"one rank under NCCL counts {one['headline']}, phase 4's process "
                             f"{headline['dispatch']}")
    print(f"[35 nccl] the headline (4096 x 8, 0.8 dB) in one rank under an NCCL group, "
          f"n_devices=1: one dispatch from step 0 counts bit errors {one['headline'][0]:.0f}, frame "
          f"errors {one['headline'][1]:.0f}, mean iterations {one['headline'][2]:.4f}, equal to "
          f"phase 4's; {one['mbit_s']:.2f} Mbit/s coded with an all-reduce a dispatch (phase 4 "
          f"{headline['mbit_s']:.2f}); launches {json.dumps(one['launches'])} on {card}", flush=True)
    lap(35)

    # -- 36: two ranks sharing the card over gloo, against one process at the global batch --
    pair = rank_outputs("gloo-pair", 2)
    refs = {
        "headline": (build_headline_sim(dev, batch_per_device=8192), 0.8),
        "dvbs2_minsum": (build_matrix_sim("dvbs2_minsum", dev, dv_codes,
                                          batch_per_device=2048)[0], 1.0),
        "xla_minsum": (BERSimulator(layout, "minsum", device=dev, max_iters=50, backend="xla",
                                    batch_per_device=512, seed=0, steps_per_dispatch=4),
                       PAIR_XLA_DB),
    }
    for name, (sim, ebn0) in refs.items():
        want = [float(v) for v in sim._step(ebn0, 0, sim.quantizer_for(ebn0))]
        batch = sim.batch_per_device
        refs[name] = None  # free the reference's device memory
        del sim
        got = pair[0][name]
        if pair[1][name] != got:
            raise AssertionError(f"{name}: the ranks' all-reduced counters differ: "
                                 f"{got} and {pair[1][name]}")
        iters_equal = (got[2] == want[2] if name == "xla_minsum"
                       else abs(got[2] - want[2]) <= 1e-6 * want[2])
        if got[:2] != want[:2] or not iters_equal:
            raise AssertionError(f"{name}: two ranks count {got}, one process {want}")
        if name == "xla_minsum" and not want[2] < 49:
            raise AssertionError("the whole-batch min-sum left no step early: the lockstep exit "
                                 "went untested")
        print(f"[36 pair] {name} ({pair[0][f'{name}_decoder']}) at {ebn0} dB, 2 gloo ranks x "
              f"{batch // 2} on one card: bit errors {got[0]:.0f}, frame errors "
              f"{got[1]:.0f}, mean iterations {got[2]:.6f}; one process at {batch}: "
              f"{want[0]:.0f}, {want[1]:.0f}, {want[2]:.6f}", flush=True)
    torch.cuda.empty_cache()
    lap(36)

    # -- 37: the multi-process CLI's resume broadcast on the card --------------------------
    with tempfile.TemporaryDirectory() as tmp:
        res0, ref, absent = (str(Path(tmp) / n) for n in ("mh2.json", "ref.json", "absent.json"))
        one_process = CLI_SWEEP + ["--device", str(dev), "--batch-per-device", "16"]
        if len(simulate.main(one_process + ["--max-db", "3.0", "--results", res0])) != 1:
            raise AssertionError("the one-point sweep did not write one point")
        ref_points = simulate.main(one_process + ["--max-db", "3.1", "--results", ref])
        so = launch(2, "cli", res0, absent, *CLI_SWEEP, "--batch-per-device", "8",
                    "--max-db", "3.1")
        resumed = so.count("resuming sweep from the given state: 1 completed points")
        if any(f"multihost: process {r}/2" not in so for r in range(2)) or resumed != 2:
            raise AssertionError(f"the ranks did not both resume from the broadcast state: {so}")
        if os.path.exists(absent):
            raise AssertionError("rank 1 wrote its results file")
        got = json.loads(Path(res0).read_text())["points"]
        keys = ("ebn0_db", "errors", "frame_errors", "blocks")
        if [[p[k] for k in keys] for p in got] != [[p[k] for k in keys] for p in ref_points]:
            raise AssertionError(f"the resumed two-rank sweep wrote {got}, one process {ref_points}")
    print(f"[37 cli] regular-3-6-504 min-sum sweep, 2 gloo ranks x 8 on {dev} resumed from rank "
          f"0's one-point file (rank 1's path absent, left unwritten): points "
          f"{[[p[k] for k in keys] for p in got]} (Eb/N0, bit errors, frame errors, blocks) equal "
          f"to one process at batch 16", flush=True)
    lap(37)

    # -- 38: the dry run at world size 1 over NCCL, and the port's construction ------------
    line = dryrun.main(["--world", "1", "--device", "cuda", "--timeout", str(RANK_TIMEOUT)])
    m = re.search(r"nccl; kernel launches (\d+), channel-input launches (\d+)\)$", line)
    if not line.startswith("dryrun_multichip(1): ok") or not m or int(m.group(1)) == 0:
        raise AssertionError(f"the dry run printed {line!r}")
    launched.update(k1=int(m.group(1)), uniform_clusters=int(m.group(2)))
    print(f"[38 dryrun] {line}", flush=True)
    fresh, mismatched = None, []
    for name in COMMITTED_CONFIGS:
        t0 = time.perf_counter()
        cfg = rebuild_committed_config(name)
        seconds = time.perf_counter() - t0
        with tempfile.TemporaryDirectory() as tmp:
            cfg.save(str(Path(tmp) / "x.npz"))
            with np.load(Path(tmp) / "x.npz") as z, np.load(CONFIG_DIR / f"{name}.npz") as w:
                if set(z.files) != set(w.files):
                    raise AssertionError(f"{name}: keys {sorted(set(z.files) ^ set(w.files))} differ")
                diff = next((k for k in w.files if not np.array_equal(z[k], w[k])), None)
                if diff is not None:
                    mismatched.append(name)
                    got, want = z[diff], w[diff]
                    if got.shape != want.shape:
                        where = f"shape {got.shape} against {want.shape}"
                    else:
                        i = tuple(np.argwhere(got != want)[0])
                        where = f"first at {i}: {got[i]!r} against {want[i]!r}"
                    print(f"[38 construct] {name}: built in {seconds:.2f} s on this host; array "
                          f"{diff} differs from the committed file, {where}", flush=True)
        if diff is None:
            print(f"[38 construct] {name}: built in {seconds:.2f} s on this host, every array equal "
                  "to the committed file", flush=True)
        if name == "wlan_T16_0.8":
            fresh = cfg
    sim = build_headline_sim(dev, trellis=DeviceTrellis.from_tables(fresh.tables, dev))
    sim.fused_decoder.launches = 0
    from informationbottleneckdecodingldpc_torch.kernels import philox_planes

    philox_planes.launches.clear()
    if "wlan_T16_0.8" not in mismatched:
        counts = [float(v) for v in sim._step(0.8, 0, sim.quantizer_for(0.8))]
        if counts != headline["dispatch"]:
            raise AssertionError(f"the rebuilt config's headline dispatch counts {counts}, phase "
                                 f"4's {headline['dispatch']}")
        print(f"[38 headline] one headline dispatch with the config built here counts {counts}, "
              "equal to phase 4's", flush=True)
    else:
        # Construction differed on this host: the decoder built here is held to
        # phase 4's bands instead (fixed before any run, not after it).
        point = sim.run_point(0.8, min_errors=10**12, max_blocks=8192)
        if abs(point.fer - 0.666) > 0.07 or abs(point.ber - 0.0745) > 0.15 * 0.0745:
            raise AssertionError(f"the config built here decodes FER {point.fer}, BER {point.ber} "
                                 "at 0.8 dB, outside phase 4's bands")
        print(f"[38 headline] the config built here at 0.8 dB over {point.blocks} blocks: FER "
              f"{point.fer:.4f} (0.666 +- 0.07), BER {point.ber:.5f} (0.0745 +- 15%)", flush=True)
    launched.update(k1=sim.fused_decoder.launches, **philox_planes.launches)
    lap(38)
    return launched


def api_queue_phase(dev, card: str, lap, layout) -> collections.Counter:
    """Phase 39: the last public API and the results queue on the card, at
    the headline's width (WLAN N=1296, IB |T|=16, ``wlan_T16_0.8``, 4096
    codewords). Returns the launches of K1 (the factory's decoder) and of the
    Philox kernel's uniform plane (the keyed samplers)."""
    import shutil

    import numpy as np

    from informationbottleneckdecodingldpc_torch.channel import (
        AWGNChannelQuantizer, sample_clusters_from_uniform, sample_llrs_from_uniform,
        sigma2_from_ebn0_db)
    from informationbottleneckdecodingldpc_torch.cli import queue
    from informationbottleneckdecodingldpc_torch.construct import DecoderConfig
    from informationbottleneckdecodingldpc_torch.kernels import (
        FusedIBDecoder, ib_lut_decode_tiled, make_fused_ib_decoder, philox_planes)
    from informationbottleneckdecodingldpc_torch.sim import rng
    from informationbottleneckdecodingldpc_torch.utils.benchmarks import CONFIG_DIR

    launched = collections.Counter()
    rows, batch = layout.n_vars, 4096

    # -- 39a: the quantizer class and the keyed samplers ------------------------------------
    sigma2 = sigma2_from_ebn0_db(0.8, layout.code_rate)
    q = AWGNChannelQuantizer(sigma2, 3.0, 16, 2000, device="cuda")
    host = AWGNChannelQuantizer(sigma2, 3.0, 16, 2000, device="cpu")
    g = torch.Generator(device=dev)
    g.manual_seed(39)
    y = 1.0 + math.sqrt(sigma2) * torch.randn((rows, batch), generator=g, device=dev)
    for op in ("quantize", "quantize_llr"):
        got, want = getattr(q, op)(y), getattr(host, op)(y.cpu())
        if not torch.equal(got.cpu(), want):
            raise AssertionError(f"{op} on the card differs from the CPU class in "
                                 f"{int((got.cpu() != want).sum())} elements")
    key = rng.key_words(0x39ABCDEF01234567)
    bits = torch.randint(0, 2, (rows, batch), generator=g, device=dev, dtype=torch.int8)
    philox_planes.launches.clear()
    clusters, llrs = q.sample_clusters(key, bits), q.sample_llrs(key, bits)
    zeros = q.sample_clusters(key, torch.zeros_like(bits))
    launched["uniform"] = philox_planes.launches["uniform"]
    if philox_planes.launches != collections.Counter(uniform=3):
        raise AssertionError(f"the keyed samplers launched {dict(philox_planes.launches)}, not one "
                             "uniform plane each")
    t = q.device_tables
    u = rng.plane_plain("uniform", key, rows, 0, batch, device=dev)
    if not (torch.equal(clusters, sample_clusters_from_uniform(t.cdf, u, bits))
            and torch.equal(llrs, sample_llrs_from_uniform(t.cdf, t.llrs, u, bits))
            and torch.equal(zeros, sample_clusters_from_uniform(t.cdf, u, torch.zeros_like(bits)))):
        raise AssertionError("the keyed samplers on the card differ from the plain uniforms' samples")
    # All-zero bits: each cluster's share within 5 binomial standard deviations of p(t|x=0).
    n = zeros.numel()
    emp = torch.bincount(zeros.flatten().long(), minlength=16).cpu().numpy() / n
    p = np.diff(q.tables.cdf_t_given_x0)
    band = 5 * np.sqrt(p * (1 - p) / n)
    if np.any(np.abs(emp - p) > band):
        raise AssertionError(f"cluster shares {emp} outside 5 sd of {p}")
    print(f"[39 quantizer] AWGNChannelQuantizer(sigma2 {sigma2:.6f} = 0.8 dB, 3.0, 16, 2000) on "
          f"{dev}: quantize and quantize_llr of a {rows} x {batch} plane equal the CPU class's; "
          "sample_clusters / sample_llrs (random bits) and sample_clusters (zero bits), one Philox "
          "uniform plane each, equal the plain plane's samples; all-zero shares within 5 sd "
          f"(largest |share - p| {np.abs(emp - p).max():.2e}, band {band.max():.2e}) on {card}",
          flush=True)

    # -- 39b: the decoder factory ------------------------------------------------------------
    tables = DecoderConfig.load(str(CONFIG_DIR / "wlan_T16_0.8.npz")).tables
    dec = make_fused_ib_decoder(layout, tables)
    ref = FusedIBDecoder(layout, tables)
    got, want = dec(zeros), ref(zeros)
    torch.cuda.synchronize()
    launched["k1"] = dec.launches
    bt = dec.batch_tile
    twin = ib_lut_decode_tiled(layout, dec.trellis(dev), zeros[:, :2 * bt], bt)
    if not (isinstance(dec, FusedIBDecoder) and dec.launches == 1
            and torch.equal(got.outputs, want.outputs)
            and torch.equal(got.unsatisfied, want.unsatisfied)
            and float(got.iterations) == float(want.iterations)):
        raise AssertionError("make_fused_ib_decoder's decoder differs from a FusedIBDecoder")
    if not (torch.equal(got.outputs[:, :2 * bt], twin.outputs)
            and torch.equal(got.unsatisfied[:2 * bt], twin.unsatisfied)):
        raise AssertionError("the factory's K1 differs from its twin on the first two tiles")
    print(f"[39 factory] make_fused_ib_decoder(wlan-1296, wlan_T16_0.8) decodes the {batch} "
          f"sampled codewords in one K1 launch equal to a FusedIBDecoder's (outputs, unsatisfied, "
          f"mean iterations {float(got.iterations):.4f}) and, on its first two tiles of {bt}, to "
          f"the twin on {card}", flush=True)
    del y, bits, clusters, llrs, zeros, u, got, want, twin
    torch.cuda.empty_cache()

    # -- 39c: the queue at reduced depth, in a root of its own ------------------------------
    root = Path(__file__).resolve().parent / "chiprun_out" / "queue39"
    shutil.rmtree(root, ignore_errors=True)
    base = next(s for s in queue.SWEEPS if s.name == "wlan_ib_T16_enc")
    cut = " --max-db 0.8 --min-errors 1000000000"
    sweep = queue.Sweep(base.name, base.args + cut + " --max-blocks-per-point 4096")
    straight = queue.Sweep("wlan_ib_T16_enc_straight",
                           base.args + cut + " --start-db 0.8 --max-blocks-per-point 8192")
    extension = queue.Extension(base.name, 0.8, 10**9, 8192, 512)
    config = [c for c in queue.CONFIGS if c[0] == "wlan_T16_0.8"]
    for stages, sweeps, extensions in ((["configs", "sweeps", "extend"], [sweep], [extension]),
                                       (["sweeps"], [straight], []), (["report"], [], [])):
        t0 = time.perf_counter()
        failed = queue.run(stages, config, sweeps, extensions, root, "cuda")
        seconds = time.perf_counter() - t0
        if failed:
            logs = {f.name: f.read_text()[-2000:] for f in (root / queue.LOG_DIR).glob("*.log")}
            raise AssertionError(f"queue stages {failed} failed; logs: {json.dumps(logs)}")
        print(f"[39 queue] stages {','.join(stages)} ({', '.join(s.name for s in sweeps) or '-'}) "
              f"in {seconds:.1f} s on {card}", flush=True)
    with np.load(root / queue.CFG_DIR / "wlan_T16_0.8.npz") as z, \
            np.load(CONFIG_DIR / "wlan_T16_0.8.npz") as w:
        same = set(z.files) == set(w.files) and all(np.array_equal(z[k], w[k]) for k in w.files)
    points = json.loads((root / sweep.results).read_text())["points"]
    (ref_point,) = json.loads((root / straight.results).read_text())["points"]
    extended = points[-1]
    keys = ("errors", "frame_errors", "blocks")
    if [p["ebn0_db"] for p in points] != [0.6, 0.7, 0.8] or [p["blocks"] for p in points] != [
            4096, 4096, 8192]:
        raise AssertionError(f"the queue's sweep wrote {points}")
    if ([extended[k] for k in keys] != [ref_point[k] for k in keys]
            or abs(extended["mean_iterations"] - ref_point["mean_iterations"]) > 1e-9):
        raise AssertionError(f"the extended 0.8 dB point {extended} differs from the straight "
                             f"run's {ref_point}")
    report = (root / "results/torch/PARITY.md").read_text()
    header = f"Card: {nvidia_smi()}."
    if header not in report or "| 0.8 | " not in report:
        raise AssertionError(f"the report lacks the card line {header!r} or the 0.8 dB row")
    print(f"[39 queue] configs stage: wlan_T16_0.8 built on this host, "
          f"{'every array equal to' if same else 'NOT equal to'} the committed file; sweep "
          f"wlan_ib_T16_enc (encoded, 512 x 8, seed 20) 0.6-0.8 dB at 4096 blocks a point, 0.8 dB "
          f"reopened and extended to 8192: errors, frame errors, blocks "
          f"{[extended[k] for k in keys]}, mean iterations {extended['mean_iterations']:.6f}, "
          f"equal to a straight run's {[ref_point[k] for k in keys]}, "
          f"{ref_point['mean_iterations']:.6f}; coded Mbit/s a point (the first carries the first "
          f"launches) "
          f"{[round(p['coded_bits_per_s'] / 1e6, 2) for p in points]}, straight "
          f"{ref_point['coded_bits_per_s'] / 1e6:.2f}; PARITY.md written with {header!r}; the "
          "child processes' launches are not counted", flush=True)
    lap(39)
    return launched


def encoder_phase(dev, card: str, lap, main_launches: dict[str, int]) -> list[dict]:
    """Phase 40: the encoder kernel against its plain version at
    :data:`ENCODER_CASES`, each timed (device time) beside its bound (the
    info plane read once and the codeword written once; on the dense path
    also the product's m ceil(m / 32) AND-XORs a codeword, one LOP3 each)
    and the plain version's; then DVB-S2 through :data:`ENCODER_SHAPE_RUNS`,
    each call against the plain version. ``main_launches`` counts the
    engine's encoder launches by path in phases 9 (dense) and 14
    (staircase). Returns the kernels' records of the staircase and dense
    paths at the benchmark's shapes, each with its own main-path launches."""
    import numpy as np

    from informationbottleneckdecodingldpc_torch.codes.random_codes import regular_parity_check
    from informationbottleneckdecodingldpc_torch.encode import LDPCEncoder, device_encoder
    from informationbottleneckdecodingldpc_torch.kernels import encoder as kernel
    from informationbottleneckdecodingldpc_torch.kernels._build import load_library
    from informationbottleneckdecodingldpc_torch.models import get_model
    from informationbottleneckdecodingldpc_torch.sim import rng
    from informationbottleneckdecodingldpc_torch.utils import roofline
    from informationbottleneckdecodingldpc_torch.utils.peaks import device_ms

    _, build = load_library("encoder")
    print(f"[40 build] encoder.cu: nvcc {build['seconds']:.2f} s; {ptxas_lines(build['log'])}",
          flush=True)
    encoders = {name: device_encoder(LDPCEncoder(get_model(name).make_h()), dev)
                for name in ("dvbs2-64800", "wlan-1296")}
    A = regular_parity_check(8000, 3, 6, seed=0)[:, :4000].tocsr()
    inverse = np.random.default_rng(40).integers(0, 2, (4000, 4000)).astype(np.uint8)
    encoders["random-dense-4000"] = kernel.DeviceEncoder(4000, 8000, A.indptr, A.indices, inverse, dev)
    key = rng.key_words(0x0123456789ABCDEF)
    rows = {}
    for name, batch in ENCODER_CASES:
        enc = encoders[name]
        info = rng.draw("bits", key, enc.k, 0, batch, dev)
        before = enc.launches
        got, again = enc(info), enc(info)
        if enc.launches != before + 2:
            raise AssertionError(f"{enc.launches - before} encoder launches for 2 calls")
        want = enc.plain(info)
        ms = device_ms(lambda: enc(info))
        plain_ms = device_ms(lambda: enc.plain(info))
        if not all(torch.equal(x, want) for x in (got, again, enc(info))):
            raise AssertionError(f"the encoder kernel disagrees with its plain version on {name} at "
                                 f"batch {batch} in {int((got != want).sum())} bits")
        m = enc.n - enc.k
        lop3 = 0 if enc.is_staircase else m * -(-m // 32) * batch
        b = roofline.bound((enc.k + enc.n) * batch, {"logic": lop3})
        print(f"[40 exact] {name} ({'staircase' if enc.is_staircase else 'dense B^-1'}), batch "
              f"{batch}: equal to the plain version; kernel {ms:.4f} ms, bound {b['bound_ms']:.4f} ms "
              f"({b['bound_by']}: bytes {b['io_ms']:.4f}, operations {b['compute_ms']:.4f}), "
              f"{100 * b['bound_ms'] / ms:.1f}% of it; plain {plain_ms:.4f} ms on {card}", flush=True)
        rows[name, batch] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b["bound_ms"], bound_by=b["bound_by"])
    enc = device_encoder(LDPCEncoder(get_model("dvbs2-64800").make_h()), dev)
    planes = {batch: rng.draw("bits", key, enc.k, batch, batch, dev) for batch in set(ENCODER_SHAPE_RUNS)}
    wants = {batch: enc.plain(info) for batch, info in planes.items()}
    for i, batch in enumerate(ENCODER_SHAPE_RUNS):
        got = enc(planes[batch])
        if not torch.equal(got, wants[batch]):
            bits = int((got != wants[batch]).sum())
            raise AssertionError(f"the staircase kernel disagrees with its plain version at call {i} "
                                 f"(batch {batch}) of the shape runs in {bits} bits")
    print(f"[40 shapes] a fresh DVB-S2 encoder through {len(ENCODER_SHAPE_RUNS)} calls (batches 1024 "
          "and 128 in turn 40 times, then 70 of 1024): each equal to the plain version", flush=True)
    print(f"[40 launches] {sum(e.launches for e in encoders.values()) + enc.launches} by this phase's "
          f"checks; by the engine, one an encoded step: {main_launches['dense']} dense in phase 9, "
          f"{main_launches['staircase']} staircase in phase 14", flush=True)
    lap(40)
    replaces = "none: XLA (informationbottleneckdecodingldpc_tpu/encode/encoder.py device_encoder)"
    return [{"name": f"encoder_{path}", "route": "cuda",
             "source": "informationbottleneckdecodingldpc_torch/csrc/encoder.cu", "replaces": replaces,
             "launches": main_launches[path], "max_abs_err": 0, "library_ms": None, **rows[case]}
            for path, case in (("staircase", ("dvbs2-64800", 1024)), ("dense", ("wlan-1296", 512)))]


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device; none is available")
    if sys.argv[1:2] == ["--mary-profile"]:  # phase 33's own process
        print(json.dumps(mary_profile(float(sys.argv[2]))))
        return
    if sys.argv[1:2] == ["--rank"]:  # a rank of phases 35-37
        rank_main(sys.argv[2:])
        return
    started = time.perf_counter()
    card = nvidia_smi()
    print(f"[1 device] {card}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)

    lap = Lap()
    from informationbottleneckdecodingldpc_torch.channel import (
        build_quantizer_tables,
        device_tables,
        sample_clusters_from_uniform,
        sample_llrs_from_uniform,
        sigma2_from_ebn0_db,
    )
    from informationbottleneckdecodingldpc_torch.construct import DecoderConfig
    from informationbottleneckdecodingldpc_torch.cli import simulate
    from informationbottleneckdecodingldpc_torch.decode import (
        DeviceTrellis,
        belief_propagation_decode,
        ib_lut_decode,
        min_sum_decode,
    )
    from informationbottleneckdecodingldpc_torch.encode import LDPCEncoder
    from informationbottleneckdecodingldpc_torch.kernels import (
        FusedFloatDecoder,
        FusedIBDecoder,
        HBMFloatDecoder,
        HBMFusedIBDecoder,
        float_decode_tiled,
        ib_lut_decode_tiled,
    )
    from informationbottleneckdecodingldpc_torch.cli import bench_matrix
    from informationbottleneckdecodingldpc_torch.kernels.float_hbm import STATE_SLICE, state_slice
    from informationbottleneckdecodingldpc_torch.kernels import (
        float_fused,
        hbm_copy,
        ib_lut_fused,
        philox_planes,
    )
    from informationbottleneckdecodingldpc_torch.kernels import peaks as k5
    from informationbottleneckdecodingldpc_torch.kernels._build import load_library
    from informationbottleneckdecodingldpc_torch.models import get_model
    from informationbottleneckdecodingldpc_torch.sim import BERSimulator
    from informationbottleneckdecodingldpc_torch.channel.awgn import received_plane
    from informationbottleneckdecodingldpc_torch.utils.benchmarks import (
        CONFIG_DIR,
        MATRIX,
        build_headline_sim,
        build_matrix_sim,
        measure_sim_throughput,
    )
    from informationbottleneckdecodingldpc_torch.utils import peaks, roofline

    dev = torch.device("cuda")

    lap(1)

    # -- 2: build (every library's nvcc run starts at once) -----------------
    t0 = time.perf_counter()
    libraries = ("ib_lut_fused", "float_fused", "ib_lut_hbm", "float_hbm", "peaks", "hbm_copy",
                 *PROBE_LIBRARIES, *LATE_LIBRARIES)
    with ThreadPoolExecutor(len(libraries)) as pool:
        builds = {n: pool.submit(load_library, n) for n in libraries}
        _, build = builds["ib_lut_fused"].result()
        k1_loaded = time.perf_counter() - t0
        _, k2_build = builds["float_fused"].result()
        k2_loaded = time.perf_counter() - t0
        hbm_builds = {n: builds[n].result()[1] for n in ("ib_lut_hbm", "float_hbm")}
        roof_builds = {n: builds[n].result()[1] for n in ("peaks", "hbm_copy")}
        probe_builds = {n: builds[n].result()[1] for n in PROBE_LIBRARIES}
        late_builds = {n: builds[n].result()[1] for n in LATE_LIBRARIES}
        all_loaded = time.perf_counter() - t0
    k1_names = {f"kernelILb{r}ELi{v}ELb0ELb0E": f"{'shared' if r else 'device'} routes, V={v}"
                for r in (0, 1) for v in (1, 4)}
    k1_names["kernelILb0ELi4ELb1ELb0E"] = "per-lane tables, 4-bit views, V=4"
    k1_names["kernelILb0ELi4ELb1ELb1E"] = "per-lane tables on thread-block clusters"
    k1_ptxas = ptxas_lines(build["log"], k1_names)
    print(f"[2 build] ib_lut_fused.cu: nvcc {build['seconds']:.2f} s, load "
          f"{k1_loaded:.2f} s; threads per CTA at V columns per thread "
          f"{json.dumps(ib_lut_fused.THREADS)}; {k1_ptxas}", flush=True)
    if re.search(r"[1-9]\d* bytes spill (stores|loads)", k1_ptxas):
        raise AssertionError("a K1 instantiation spills registers")
    lap(2)

    # -- 3: kernel vs plain twin -----------------------------------------
    layout = get_model("wlan-1296").make_layout()
    reg_layout = get_model("regular-3-6-8000").make_layout()
    configs = {
        name: DecoderConfig.load(str(CONFIG_DIR / f"{name}.npz"))
        for name in ("wlan_T16_0.8", "wlan_T32_0.6", "regular_T16_1.05")
    }

    def clusters(cfg, ebn0_db: float, batch: int, seed: int, lay=layout) -> torch.Tensor:
        tch = cfg.tables.cardinality_t_channel
        qt = device_tables(
            build_quantizer_tables(
                sigma2_from_ebn0_db(ebn0_db, lay.code_rate), 3.0, tch, 2000
            ),
            dev,
        )
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        u = torch.rand((lay.n_vars, batch), generator=g, device=dev)
        return sample_clusters_from_uniform(qt.cdf, u, torch.zeros_like(u, dtype=torch.int32))

    max_abs_err = 0

    def ib_odd_even_tiles(cfg, levels, bt: int, imax: int, seed: int):
        """Three tiles of ``bt`` codewords for K1's exit parity: the first drawn
        at ``levels`` (dB, tried in turn, each try a new seed) that the twin
        leaves after an even and after an odd number of bodies, then one at
        0.8 dB that runs to the end; and each tile's body count."""
        twin = FusedIBDecoder(layout, cfg.tables, max_iters=imax)
        bodies = lambda x: int(ib_lut_decode_tiled(layout, twin.trellis(dev), x, bt, imax).iterations)
        found, tried = {}, []
        for j, db in enumerate(levels * 8):
            x = clusters(cfg, db, bt, seed=seed + j)
            b = bodies(x)
            tried.append(b)
            if b < imax - 1:
                found.setdefault(b % 2, (x, b))
            if len(found) == 2:
                break
        else:
            raise AssertionError(f"no K1 tiles at {levels} dB leave after both odd and even "
                                 f"bodies: {tried}")
        last = clusters(cfg, 0.8, bt, seed=seed + 99)
        tiles = [found[0], found[1], (last, bodies(last))]
        if tiles[2][1] != imax - 1:
            raise AssertionError("the 0.8 dB tile left early")
        return torch.cat([x for x, _ in tiles], 1), [b for _, b in tiles]

    cases = [  # (tables, Eb/N0 (per tile), batch, max_iters, early exit, alignment)
        ("wlan_T16_0.8", 0.8, 512, None, True, True),
        ("wlan_T16_0.8", 0.8, 512, None, False, True),
        ("wlan_T16_0.8", 6.0, 512, None, True, True),
        ("wlan_T16_0.8", 6.0, 512, None, False, True),
        ("wlan_T32_0.6", 0.8, 512, None, False, True),
        ("wlan_T32_0.6", 6.0, 512, None, True, True),
        ("wlan_T16_0.8", 6.0, 500, None, True, True),  # the last tile padded
        ("wlan_T16_0.8", 6.0, 512, None, True, False),
        ("wlan_T16_0.8", (6.0, 5.0, 4.0, 3.0), None, None, True, True),
        *(("wlan_T16_0.8", 8.0, 512, imax, ee, True) for imax in (1, 2, 3) for ee in (True, False)),
        ("wlan_T16_0.8", 0.8, 4096, None, True, True),  # the benchmark's sizes
        ("wlan_T32_0.6", 0.6, 2048, None, True, True),
        # the queue's batch on thread-block clusters, and 1024 on clusters of 2
        ("wlan_T16_0.8", 2.4, 512, None, True, True),
        ("wlan_T16_0.8", 2.4, 512, None, False, True),
        ("wlan_T16_0.8", 2.4, 500, None, True, True),
        ("wlan_T16_0.8", 2.4, 1024, None, True, True),
        *(("regular_T16_1.05", 1.2, 8, REG_TWIN_IMAX, ee, True) for ee in (True, False)),
    ]
    k1_counts = {}  # (tables, batch) -> (launches, cluster launches, CTAs a tile)
    for k, (name, ebn0, batch, imax, early_exit, matching) in enumerate(cases):
        cfg = configs[name]
        lay = reg_layout if name.startswith("regular") else layout
        dec = FusedIBDecoder(lay, cfg.tables, max_iters=imax, early_exit=early_exit,
                             use_matching=matching)
        carve = ib_lut_fused.kernel_shared_bytes(lay, dec.batch_tile, cfg.tables.cardinality_t_channel,
                                                 cfg.tables.cardinality_t_decoder)
        label = f"{ebn0} dB"
        if isinstance(ebn0, tuple):
            ch, bodies = ib_odd_even_tiles(cfg, ebn0, dec.batch_tile, dec.imax, seed=300 + k)
            label = f"per-tile levels {ebn0} dB, tiles leave after {bodies} bodies,"
        else:
            ch = clusters(cfg, ebn0, batch, seed=k, lay=lay)
        got = dec(ch)
        ref = ib_lut_decode_tiled(
            lay, dec.trellis(dev), ch, dec.batch_tile, max_iters=imax, early_exit=early_exit
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
                f"K1 disagrees with its twin on {name} {label} max_iters {imax} early_exit="
                f"{early_exit} matching={matching}: max |out diff| {err}, iterations "
                f"{float(got.iterations)} vs {float(ref.iterations)}"
            )
        if early_exit and ebn0 == 6.0 and float(got.iterations) >= 49.0:
            raise AssertionError("early exit did not fire at 6.0 dB")
        k1_counts[name, ch.shape[1]] = (dec.launches, dec.cluster_launches, dec.cluster)
        path = "per-lane tables" if carve.lanes else (
            f"one table copy a block, routes in {'shared' if carve.shared_routes else 'device'} memory")
        if dec.cluster > 1:  # the same tiles at one CTA a tile
            one = FusedIBDecoder(lay, cfg.tables, max_iters=imax, early_exit=early_exit,
                                 use_matching=matching)._launch(ch, cluster=1)
            torch.cuda.synchronize()
            if not (torch.equal(got.outputs, one.outputs)
                    and torch.equal(got.unsatisfied, one.unsatisfied)
                    and float(got.iterations) == float(one.iterations)):
                raise AssertionError(f"K1 on clusters of {dec.cluster} disagrees with one CTA a "
                                     f"tile on {name} {label} batch {ch.shape[1]}")
            path += f" on clusters of {dec.cluster}, equal to one CTA a tile"
        print(f"[3 exact] {name} {label} max_iters {dec.imax} early_exit={early_exit} "
              f"matching={matching} batch {ch.shape[1]} tile {dec.batch_tile} ({path}, "
              f"{carve.bytes} B): outputs, unsatisfied and mean iterations "
              f"{float(got.iterations):.4f} equal", flush=True)
    t16 = {b: k1_counts["wlan_T16_0.8", b] for b in (512, 1024, 4096)}
    t32 = k1_counts["wlan_T32_0.6", 2048]
    active = ib_lut_fused._max_active_clusters(torch.cuda.current_device(), layout.n_vars,
                                               layout.n_edges, 16, 16, 16, layout.d_c_max,
                                               layout.d_v_max)
    print(f"[3 launches] K1's (launches, cluster_launches, CTAs a tile): |T|=16 at 512 "
          f"{t16[512]}, at 1024 {t16[1024]}, at 4096 {t16[4096]}; |T|=32 at 2048 {t32}; "
          f"clusters the card holds at once at |T|=16's carve, by CTAs a cluster: {active}",
          flush=True)
    if not (t16[512][1] == t16[512][0] and t16[512][2] > 1 and t16[1024][1] == t16[1024][0]
            and t16[4096][1] == 0 and t32[1] == 0):
        raise AssertionError(f"K1's cluster launches: {k1_counts}")
    lap(3)

    # -- 4: headline main path -------------------------------------------
    sim = build_headline_sim(dev)
    decoder = sim.fused_decoder
    decoder.launches = 0
    philox_planes.launches.clear()
    rate = measure_sim_throughput(sim, 0.8)
    timed_steps = (1 + 6) * sim.steps_per_dispatch
    point = sim.run_point(0.8, min_errors=10**12, max_blocks=8192)
    high = sim.run_point(2.4, min_errors=10**12, max_blocks=8192)
    launches = decoder.launches
    steps = timed_steps + (point.blocks + high.blocks) // sim.batch_total
    main_counts = collections.Counter(philox_planes.launches)
    if launches != steps or main_counts != collections.Counter(uniform_clusters=steps):
        raise AssertionError(f"{launches} K1 and {dict(main_counts)} Philox launches for {steps} "
                             "steps, not one of each and no plane per step")
    print(f"[4 headline] {rate / 1e6:.2f} Mbit/s coded on {card}; "
          f"{launches} K1 and {main_counts['uniform_clusters']} channel-input (uniform -> "
          f"clusters) launches for {steps} steps, no uniform plane", flush=True)
    headline = {"dispatch": same_counters(sim, 0.8, "4"), "mbit_s": rate / 1e6}
    fer_ok = abs(point.fer - 0.666) <= 0.07
    ber_ok = abs(point.ber - 0.0745) <= 0.15 * 0.0745
    print(f"[4 point] 0.8 dB: {point.blocks} blocks, FER {point.fer:.4f} "
          f"(0.666 +- 0.07), BER {point.ber:.5f} (0.0745 +- 15%), mean "
          f"iterations {point.mean_iterations:.3f}; 2.4 dB: FER {high.fer:.5f}, "
          f"BER {high.ber:.3e}, mean iterations {high.mean_iterations:.3f}",
          flush=True)
    if not (fer_ok and ber_ok):
        raise AssertionError("FER or BER at 0.8 dB outside its band")
    lap(4)

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
    k1_iters = float(got.iterations)
    fixed = FusedIBDecoder(layout, cfg.tables, early_exit=False)
    fixed_ms = cuda_ms(lambda: fixed(ch))
    print(f"[5 times] batch 4096 decode at 0.8 dB: K1 {ms:.3f} ms with early exit (mean "
          f"iterations {k1_iters:.3f}), {fixed_ms:.3f} ms without (49 bodies), plain twin "
          f"{plain_ms:.1f} ms on {card}", flush=True)
    # The queue's batch: tiles on thread-block clusters against one CTA a tile.
    ch = clusters(cfg, 2.4, 512, seed=98)
    queue = FusedIBDecoder(layout, cfg.tables)
    queue_ms = cuda_ms(lambda: queue(ch))
    queue_cluster = queue.cluster
    one_ms = cuda_ms(lambda: queue._launch(ch, cluster=1))
    print(f"[5 times] batch 512 decode at 2.4 dB: K1 {queue_ms:.3f} ms on clusters of "
          f"{queue_cluster}, {one_ms:.3f} ms at one CTA a tile on {card}", flush=True)
    lap(5)

    # -- 6: K2 build ------------------------------------------------------
    print(f"[6 build] float_fused.cu: nvcc {k2_build['seconds']:.2f} s (beside "
          f"K1), both loaded after {k2_loaded:.2f} s; threads per CTA at most "
          f"{json.dumps(float_fused.THREADS)} (on WLAN, " + ", ".join(
              f"{rule} {t // bt} nodes x {bt} columns" for rule, t in float_fused.THREADS.items()
              for bt in [float_fused.pick_float_batch_tile(layout)]) + "); "
          f"{ptxas_lines(k2_build['log'], {'ILi0E': 'minsum', 'ILi1E': 'bp'})}",
          flush=True)
    lap(6)

    # -- 7: K2 vs plain twin ---------------------------------------------
    rules = ("minsum", "bp")
    k2_err = dict.fromkeys(rules, 0.0)

    def float_llrs(ebn0_db: float, batch: int, seed: int, true: bool = False, lay=layout):
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        shape = (lay.n_vars, batch)
        sigma2 = float(sigma2_from_ebn0_db(ebn0_db, lay.code_rate))
        if true:
            noise = torch.randn(shape, generator=g, device=dev)
            zeros = torch.zeros(shape, dtype=torch.int8, device=dev)
            return 2.0 * received_plane(zeros, noise, sigma2) / sigma2
        qt = device_tables(build_quantizer_tables(sigma2, 3.0, 16, 2000), dev)
        u = torch.rand(shape, generator=g, device=dev)
        return sample_llrs_from_uniform(
            qt.cdf, qt.llrs, u, torch.zeros(shape, dtype=torch.int32, device=dev)
        )

    def forced_llrs(batch: int, seed: int, lay) -> torch.Tensor:
        """LLRs that force K4's rare cases: multiples of 1 (ties of the least
        magnitudes), 10% +0 and 10% -0 (checks with one and with two or more
        zero inputs), 2% scaled by 90 (inputs above the +-150 clamp)."""
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        shape = (lay.n_vars, batch)
        x = torch.round(torch.randn(shape, generator=g, device=dev) * 3 + 1)
        r = torch.rand(shape, generator=g, device=dev)
        x = torch.where(r < 0.1, torch.zeros_like(x), x)
        x = torch.where(r > 0.9, -torch.zeros_like(x), x)
        return torch.where((r > 0.45) & (r < 0.47), x * 90, x)

    def same(got, ref) -> bool:
        return (
            bool((got.outputs == ref.outputs).all())
            and torch.equal(got.unsatisfied, ref.unsatisfied)
            and float(got.iterations) == float(ref.iterations)
        )

    def odd_even_tiles(rule: str, levels, bt: int, imax: int, seed: int, lay):
        """Three tiles of ``bt`` codewords for K2's and K4's exit parity: the first
        drawn at ``levels`` (dB, tried in turn, each try a new seed) that the
        twin leaves after an even and after an odd number of bodies, then one
        at 1.0 dB that runs to the end; and each tile's body count."""
        found = {}
        for j, db in enumerate(levels * 4):
            x = float_llrs(db, bt, seed=seed + j, lay=lay)
            b = int(float_decode_tiled(lay, x, rule, bt, imax).iterations)
            if b < imax - 1:
                found.setdefault(b % 2, (x, b))
            if len(found) == 2:
                break
        else:
            raise AssertionError(f"no tiles at {levels} dB leave after both odd and even bodies")
        last = float_llrs(1.0, bt, seed=seed + 99, lay=lay)
        tiles = [found[0], found[1], (last, int(float_decode_tiled(lay, last, rule, bt, imax).iterations))]
        return torch.cat([x for x, _ in tiles], 1), [b for _, b in tiles]

    float_cases = [  # (label, Eb/N0 (per tile), true LLRs, max_iters, early exit)
        ("quantized", 2.0, False, 50, True),
        ("quantized", 2.0, False, 50, False),
        ("quantized", 4.0, False, 50, True),
        ("true", 2.0, True, 50, True),
        ("quantized", 2.0, False, 1, True),
        ("quantized", 2.0, False, 1, False),
        ("quantized", 4.0, False, 2, True),
        ("quantized", 4.0, False, 2, False),
        ("quantized", 4.0, False, 3, True),
        ("quantized", 4.0, False, 3, False),
        ("quantized", WLAN_MIXED_DB, False, 50, True),
    ]
    for rule in rules:
        for k, (label, ebn0, true, imax, early_exit) in enumerate(float_cases):
            dec = FusedFloatDecoder(layout, rule, max_iters=imax, early_exit=early_exit)
            if isinstance(ebn0, tuple):
                ch, bodies = odd_even_tiles(rule, ebn0, dec.batch_tile, imax, seed=100 + k,
                                            lay=layout)
                label = f"per-tile levels, tiles leave after {bodies} bodies,"
            else:
                ch = float_llrs(ebn0, 512, seed=100 + k, true=true)
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
                  f"early_exit={early_exit} batch {ch.shape[1]} tile {dec.batch_tile}: outputs, "
                  f"unsatisfied and mean iterations {float(got.iterations):.4f} equal",
                  flush=True)
    lap(7)

    # -- 8: the float cells ------------------------------------------------
    k2_launches = {}
    for name in ("wlan_minsum", "wlan_bp_quant"):
        sim, ebn0, _ = build_matrix_sim(name, dev)
        decoder = sim.fused_decoder
        decoder.launches = 0
        rate = measure_sim_throughput(sim, ebn0)
        timed_steps = (1 + 6) * sim.steps_per_dispatch
        point = sim.run_point(ebn0, min_errors=10**12, max_blocks=32768)
        k2_launches[sim.decoder] = decoder.launches
        steps = timed_steps + point.blocks // sim.batch_total
        if decoder.launches != steps:
            raise AssertionError(f"{decoder.launches} K2 launches for {steps} steps")
        print(f"[8 cell] {name}: {rate / 1e6:.2f} Mbit/s coded on {card}; "
              f"{decoder.launches} K2 launches for {steps} steps; "
              f"{ebn0} dB over {point.blocks} blocks: FER {point.fer:.5f}, "
              f"BER {point.ber:.3e}, mean iterations {point.mean_iterations:.3f}",
              flush=True)
    lap(8)

    # -- 9: encoded chain vs the reference curves --------------------------
    H = get_model("wlan-1296").make_h()
    encoder = LDPCEncoder(H)
    ib_tables = configs["wlan_T16_0.8"].tables
    bands = [  # (decoder, chain, LLR source, Eb/N0, FER, FER band, BER, reference file)
        ("minsum", "encoded", "quantized", 1.6, 0.2791, 0.025, 0.03329, "wlan_minsum_enc"),
        ("bp", "encoded", "quantized", 1.2, 0.1267, 0.018, 0.008859, "wlan_bp_enc"),
        ("ib", "encoded", "quantized", 0.8, 0.666, 0.07, 0.0745, "wlan_ib_T16_enc"),
        # True LLRs carry more than 16 levels: FER and BER below the band's top.
        ("bp", "encoded", "true", 1.2, 0.1267, 0.018, 0.008859, "wlan_bp_enc"),
        ("minsum", "allzero", "true", 1.6, 0.2791, 0.025, 0.03329, "wlan_minsum_enc"),
    ]
    philox_planes.launches.clear()
    expected = collections.Counter()
    # The engine's encoder kernel by path, one launch an encoded step.
    encoder_launches = {"staircase": 0, "dense": 0}
    for decoder_name, chain, source, ebn0, fer_ref, fer_band, ber_ref, ref_name in bands:
        kw = dict(max_iters=50)
        if decoder_name == "ib":
            kw = dict(
                trellis=DeviceTrellis.from_tables(ib_tables, dev),
                cardinality_t_channel=ib_tables.cardinality_t_channel,
            )
        sim = BERSimulator(
            layout, decoder_name, device=dev, chain=chain, llr_source=source, encoder=encoder,
            batch_per_device=4096, steps_per_dispatch=8, seed=0, **kw,
        )
        point = sim.run_point(ebn0, min_errors=10**12, max_blocks=32768)
        steps = point.blocks // sim.batch_total
        if chain == "encoded":
            if sim._encode.launches != steps:
                raise AssertionError(f"{sim._encode.launches} encoder launches for {steps} steps")
            encoder_launches["staircase" if sim._encode.is_staircase else "dense"] += sim._encode.launches
        expected.update({sim.channel_input_kind: steps, **({"bits": steps} if chain == "encoded" else {})})
        if source == "quantized":
            ok = abs(point.fer - fer_ref) <= fer_band and abs(point.ber - ber_ref) <= 0.15 * ber_ref
            band = f"({fer_ref} +- {fer_band}), BER {point.ber:.5f} ({ber_ref} +- 15%"
        else:
            ok = point.fer <= fer_ref + fer_band and point.ber <= 1.15 * ber_ref
            band = f"(at most {fer_ref + fer_band:.4f}), BER {point.ber:.5f} (at most {1.15 * ber_ref:.5f}"
        print(f"[9 {chain}] {decoder_name} {source} LLRs {ebn0} dB: {point.blocks} blocks, FER "
              f"{point.fer:.4f} {band}, results/ber/{ref_name}.json), mean iterations "
              f"{point.mean_iterations:.3f}; channel input {sim.channel_input_kind}", flush=True)
        if not ok:
            raise AssertionError(f"{chain} {decoder_name} {source} FER or BER outside its band")
    if philox_planes.launches != expected:
        raise AssertionError(f"{dict(philox_planes.launches)} Philox launches, not {dict(expected)}: "
                             "one channel input a step, one bits plane an encoded step")
    main_counts.update(philox_planes.launches)
    print(f"[9 launches] {json.dumps(dict(philox_planes.launches))}: one channel input a step, one "
          "bits plane an encoded step, no uniform or normal plane", flush=True)
    lap(9)

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
        dec = FusedFloatDecoder(layout, rule, max_iters=50, early_exit=True)
        ee_ms = cuda_ms(lambda: dec(ch))
        print(f"[10 times] batch 4096 {rule} decode, early exit on at 2.0 dB: K2 {ee_ms:.3f} ms, "
              f"mean iterations {float(dec(ch).iterations):.3f} on {card}", flush=True)

    lap(10)

    # -- 11: K3 and K4 build (started in phase 2) ---------------------------
    # Every wide instantiation: K3's per-lane CN/VN passes and its general
    # ones, each on packed 4-bit and on byte views, with its seed and
    # decision; K4's per rule and degree range.
    ranges = {0: "low degrees", 1: "high degrees"}
    widths = {4: "packed 4-bit", 8: "byte"}
    hbm_names = {
        "ib_lut_hbm": {**{f"{p}_kernelILb{lanes}ELi{bits}EE":
                          f"{p} {w} {'8 columns per-lane tables' if lanes else 'general 4 columns'}"
                          for p in ("cn", "vn") for lanes in (1, 0) for bits, w in widths.items()},
                       **{f"{p}_kernelILi{bits}EE": f"{p} {w}"
                          for p in ("seed", "decide") for bits, w in widths.items()}},
        # The node-state kernels first: "vn_kernelILb0E" is also in their names.
        "float_hbm": {"state_cn_kernelILb1E": "state cn body 0", "state_cn_kernelILb0E": "state cn",
                      "state_syndrome_kernelILb1E": "state syndrome of the channel",
                      "state_syndrome_kernelILb0E": "state syndrome",
                      **{f"state_vn_kernelILb{h}E": f"state vn {r}" for h, r in ranges.items()},
                      "state_seed_kernel": "state seed", "state_decide_kernel": "state decide",
                      **{f"cn_kernelILi{k}ELb{h}E": f"cn {rule} {r}" for k, rule in enumerate(("minsum", "bp"))
                         for h, r in ranges.items()},
                      **{f"vn_kernelILb{h}E": f"vn {r}" for h, r in ranges.items()}},
    }
    for name, b in hbm_builds.items():
        names = {**hbm_names[name], "seed_kernel": "seed", "syndrome_kernel": "syndrome",
                 "exit_kernel": "exit", "decide_kernel": "decide"}
        print(f"[11 build] {name}.cu: nvcc {b['seconds']:.2f} s (beside K1 and K2), all "
              f"{len(libraries)} loaded after {all_loaded:.2f} s; {ptxas_lines(b['log'], names)}",
              flush=True)
    lap(11)

    # -- 12: K3 vs plain twin ------------------------------------------------
    dv_spec = get_model("dvbs2-64800")
    dv_H = dv_spec.make_h()
    dv_layout = dv_spec.make_layout(dv_H)
    for name in ("dvbs2_T16_0.6", "dvbs2_T16_0.8"):
        configs[name] = DecoderConfig.load(str(CONFIG_DIR / f"{name}.npz"))
    k3_err = 0
    k3_cases = [  # (code, layout, config, Eb/N0, batch, early exit, tile or None: 128)
        ("dvbs2", dv_layout, "dvbs2_T16_0.6", 1.0, 128, True, None),
        ("dvbs2", dv_layout, "dvbs2_T16_0.6", 1.0, 128, False, None),
        ("dvbs2", dv_layout, "dvbs2_T16_0.6", 1.0, 1024, True, None),
        ("dvbs2", dv_layout, "dvbs2_T16_0.6", 1.0, 1024, False, None),
        ("dvbs2", dv_layout, "dvbs2_T16_0.6", 1.0, 256, True, None),
        ("dvbs2", dv_layout, "dvbs2_T16_0.6", 1.0, 256, False, None),
        ("dvbs2", dv_layout, "dvbs2_T16_0.8", DV_EXIT_DB, 512, True, None),
        ("dvbs2", dv_layout, "dvbs2_T16_0.6", 1.0, 200, True, None),
        ("dvbs2", dv_layout, "dvbs2_T16_0.6", 1.0, 512, True, 256),
        ("wlan", layout, "wlan_T16_0.8", 0.8, 512, True, None),
        ("wlan", layout, "wlan_T16_0.8", 0.8, 512, True, 200),
        ("wlan", layout, "wlan_T16_0.8", 0.8, 1024, True, 1024),
        ("wlan", layout, "wlan_T32_0.6", 0.8, 512, True, None),
    ]
    for k, (code, lay, name, ebn0, batch, early_exit, tile) in enumerate(k3_cases):
        ch = clusters(configs[name], ebn0, batch, seed=200 + k, lay=lay)
        dec = HBMFusedIBDecoder(lay, configs[name].tables, early_exit=early_exit,
                                batch_tile=tile)
        ref = ib_lut_decode_tiled(
            lay, dec.trellis(dev), ch, dec.batch_tile, early_exit=early_exit
        )
        got = dec(ch)
        torch.cuda.synchronize()
        err = int((got.outputs - ref.outputs).abs().max())
        k3_err = max(k3_err, err)
        if not same(got, ref):
            raise AssertionError(
                f"K3 disagrees with its twin on {name} {ebn0} dB batch {batch} tile "
                f"{dec.batch_tile} early_exit={early_exit}: max |out diff| {err}, iterations "
                f"{float(got.iterations)} vs {float(ref.iterations)}"
            )
        if ebn0 == DV_EXIT_DB and float(got.iterations) >= 49.0:
            raise AssertionError(f"K3's early exit did not fire at {ebn0} dB")
        t = configs[name].tables
        bits = 4 if max(t.cardinality_t_channel, t.cardinality_t_decoder) <= 16 else 8
        if dec.view_bits != bits or dec.packed_launches != (dec.launches if bits == 4 else 0):
            raise AssertionError(f"K3 on {name} ran {dec.view_bits}-bit views, {dec.packed_launches} "
                                 f"of {dec.launches} decodes packed; want {bits}-bit views")
        print(f"[12 exact] K3 {name} {ebn0} dB early_exit={early_exit} batch {batch} tile "
              f"{dec.batch_tile}, {bits}-bit views ({dec.packed_launches} of {dec.launches} decodes "
              f"packed): outputs, unsatisfied and mean iterations {float(got.iterations):.4f} equal",
              flush=True)
    lap(12)

    # -- 13: K4 vs plain twin ------------------------------------------------
    k4_err = dict.fromkeys(rules, 0.0)
    k4_cases = [  # (code, layout, label, Eb/N0 (per tile), true LLRs, max_iters, early exit,
        # batch, tile or None: 128)
        ("dvbs2", dv_layout, "quantized", 1.0, False, 50, True, 256, None),
        ("dvbs2", dv_layout, "quantized", 1.0, False, 50, False, 256, None),
        ("dvbs2", dv_layout, "quantized", DV_EXIT_DB, False, 50, True, 512, None),
        ("dvbs2", dv_layout, "true", 1.0, True, 50, True, 256, None),
        ("dvbs2", dv_layout, "quantized", 1.0, False, 1, True, 256, None),
        ("dvbs2", dv_layout, "quantized", 1.0, False, 2, True, 256, None),
        ("dvbs2", dv_layout, "quantized", 1.0, False, 2, False, 256, None),
        ("dvbs2", dv_layout, "quantized", DV_MIXED_DB, False, 50, True, None, None),
        ("dvbs2", dv_layout, "quantized", 1.0, False, 50, True, 512, 256),
        ("wlan", layout, "quantized", 2.0, False, 50, True, 512, None),
        ("wlan", layout, "quantized", 2.0, False, 50, True, 512, 200),
        ("wlan", layout, "quantized", 2.0, False, 50, True, 1024, 1024),
        ("dvbs2", dv_layout, "forced (ties, zeros, clamps)", None, False, 50, True, 256, None),
        ("dvbs2", dv_layout, "forced (ties, zeros, clamps)", None, False, 20, False, 400, 200),
    ]
    for rule in rules:
        for k, (code, lay, label, ebn0, true, imax, early_exit, batch, tile) in enumerate(k4_cases):
            dec = HBMFloatDecoder(lay, rule, max_iters=imax, early_exit=early_exit,
                                  batch_tile=tile)
            bt = dec.batch_tile
            if isinstance(ebn0, tuple):
                ch, bodies = odd_even_tiles(rule, ebn0, bt, imax, seed=300 + k, lay=lay)
                batch = ch.shape[1]
                label = f"per-tile levels, tiles leave after {bodies} bodies,"
            elif ebn0 is None:
                ch = forced_llrs(batch, seed=300 + k, lay=lay)
            else:
                ch = float_llrs(ebn0, batch, seed=300 + k, true=true, lay=lay)
            got = dec(ch)
            ref = float_decode_tiled(lay, ch, rule, bt, imax, early_exit=early_exit)
            torch.cuda.synchronize()
            err = float((got.outputs - ref.outputs).abs().max())
            k4_err[rule] = max(k4_err[rule], err)
            if not same(got, ref):
                raise AssertionError(
                    f"K4 {rule} disagrees with its twin on {code} {label} LLRs at "
                    f"{ebn0} dB, max_iters {imax}, early_exit={early_exit}: max |out "
                    f"diff| {err}, iterations {float(got.iterations)} vs "
                    f"{float(ref.iterations)}"
                )
            if ebn0 == DV_EXIT_DB and float(got.iterations) >= 49.0:
                raise AssertionError(f"K4 {rule}'s early exit did not fire at {ebn0} dB")
            # Min-sum runs on the node-state path, BP on the views; the state
            # path equals the view path bit for bit, the sign of a zero too.
            if dec.state_launches != (dec.launches if rule == "minsum" else 0) or dec.launches != 1:
                raise AssertionError(f"K4 {rule} ran {dec.state_launches} of {dec.launches} decodes "
                                     "on the node-state path")
            path = "views"
            if rule == "minsum":
                views = HBMFloatDecoder(lay, rule, max_iters=imax, early_exit=early_exit,
                                        batch_tile=tile)
                views.node_state = False
                v = views(ch)
                torch.cuda.synchronize()
                if not (same(got, v) and torch.equal(got.outputs.view(torch.int32),
                                                     v.outputs.view(torch.int32))):
                    raise AssertionError(f"K4's node-state path differs from its view path on "
                                         f"{code} {label} LLRs at {ebn0} dB, max_iters {imax}")
                path = "node state, == the view path bit for bit"
            print(f"[13 exact] K4 {rule} {code} {label} LLRs {ebn0} dB max_iters {imax} "
                  f"early_exit={early_exit} batch {batch} tile {bt} ({path}; {dec.state_launches} "
                  f"of {dec.launches} decodes on the node-state path): outputs, unsatisfied and "
                  f"mean iterations {float(got.iterations):.4f} equal the twin's", flush=True)
    lap(13)

    # -- 14: the DVB-S2 cells and their reference points -----------------------
    dv_encoder = LDPCEncoder(dv_H)
    dv_codes = {"dvbs2-64800": [dv_H, dv_layout, dv_encoder]}
    hbm_launches = {}
    philox_planes.launches.clear()
    expected = collections.Counter()
    dv_bands = [  # (cell or config, decoder, Eb/N0, FER, BER, reference file)
        ("dvbs2_ib_hbm_encoded", "ib", 1.0, 1.0, 0.004030, "dvbs2_ib_enc"),
        ("dvbs2_T16_0.8", "ib", 0.9, 0.5859375, 0.02623, "dvbs2_ib_enc_d08"),
        ("dvbs2_minsum", "minsum", 1.0, 1.0, 0.14708, "dvbs2_minsum"),
    ]
    for name, decoder_name, ebn0, fer_ref, ber_ref, ref_name in dv_bands:
        if name in MATRIX:
            sim = build_matrix_sim(name, dev, dv_codes)[0]
        else:
            tables = configs[name].tables
            sim = BERSimulator(
                dv_layout, "ib", device=dev, chain="encoded", encoder=dv_encoder,
                trellis=DeviceTrellis.from_tables(tables, dev),
                cardinality_t_channel=tables.cardinality_t_channel,
                batch_per_device=1024, seed=0,
            )
        if sim.backend != "hbm":
            raise AssertionError(f"{name} runs on backend {sim.backend!r}, not 'hbm'")
        decoder = sim.fused_decoder
        decoder.launches = 0
        steps, rate = 0, None
        if name in MATRIX:
            rate = measure_sim_throughput(sim, ebn0)
            steps = (1 + 6) * sim.steps_per_dispatch
        point = dispatch_point(sim, ebn0, DV_DISPATCHES)
        steps += DV_DISPATCHES * sim.steps_per_dispatch
        if decoder.launches != steps:
            raise AssertionError(f"{decoder.launches} K3/K4 launches for {steps} steps")
        if sim.chain == "encoded":
            if sim._encode.launches != steps:
                raise AssertionError(f"{sim._encode.launches} encoder launches for {steps} steps")
            encoder_launches["staircase" if sim._encode.is_staircase else "dense"] += sim._encode.launches
        expected.update({sim.channel_input_kind: steps,
                         **({"bits": steps} if sim.chain == "encoded" else {})})
        if rate is not None:
            hbm_launches[decoder_name] = decoder.launches
        fer_band, ber_band = ref_bands(point, fer_ref)
        print(f"[14 cell] {name} ({decoder_name}, {type(decoder).__name__}): "
              + (f"{rate / 1e6:.2f} Mbit/s coded on {card}; " if rate else "")
              + f"{decoder.launches} launches for {steps} steps; {ebn0} dB over "
              f"{point['blocks']} blocks: FER {point['fer']:.5f} ({fer_ref} +- "
              f"{fer_band:.5f}), BER {point['ber']:.6f} ({ber_ref} +- {ber_band:.6f}, "
              f"results/ber/{ref_name}.json), mean iterations "
              f"{point['iterations']:.3f}", flush=True)
        if abs(point["fer"] - fer_ref) > fer_band or abs(point["ber"] - ber_ref) > ber_band:
            raise AssertionError(f"{name} FER or BER at {ebn0} dB outside its band")
        if name == "dvbs2_ib_hbm_encoded":
            counted = collections.Counter(philox_planes.launches)
            same_counters(sim, ebn0, "14")
            philox_planes.launches.clear()
            philox_planes.launches.update(counted)
    if philox_planes.launches != expected:
        raise AssertionError(f"{dict(philox_planes.launches)} Philox launches, not {dict(expected)}: "
                             "one channel input a step, one bits plane an encoded step")
    main_counts.update(philox_planes.launches)
    print(f"[14 philox] {json.dumps(dict(philox_planes.launches))}: one channel input a step, one "
          "bits plane an encoded step, no uniform or normal plane", flush=True)
    # BP through run_point and IB through the CLI, each with backend 'auto'.
    sim = BERSimulator(dv_layout, "bp", device=dev, max_iters=50, batch_per_device=256)
    sim.fused_decoder.launches = 0
    point = sim.run_point(1.0, min_errors=10**12, max_blocks=512)
    hbm_launches["bp"] = sim.fused_decoder.launches
    if sim.backend != "hbm" or hbm_launches["bp"] != 2:
        raise AssertionError(f"BP ran {hbm_launches['bp']} decodes on {sim.backend!r}")
    print(f"[14 bp] dvbs2 BP 1.0 dB through run_point: {point.blocks} blocks, FER "
          f"{point.fer:.4f}, BER {point.ber:.5f}, {hbm_launches['bp']} K4 launches",
          flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        points = simulate.main([
            "--model", "dvbs2-64800", "--config", str(CONFIG_DIR / "dvbs2_T16_0.6.npz"),
            "--chain", "encoded", "--start-db", "1.0", "--max-db", "1.0",
            "--batch-per-device", "256", "--max-blocks-per-point", "256",
            "--min-errors", "1", "--results", str(Path(tmp) / "dvbs2_ib.json"),
        ])
    if not (points[0]["blocks"] == 256 and 0.0 < points[0]["ber"] < 0.02):
        raise AssertionError(f"the DVB-S2 CLI run gave {points}")
    lap(14)

    # -- 15: one DVB-S2 decode at batch 1024, K3/K4 and the plain decoders -------
    hbm_ms, hbm_plain_ms = {}, {}
    tables = configs["dvbs2_T16_0.6"].tables
    inputs = {
        "ib": clusters(configs["dvbs2_T16_0.6"], 1.0, 1024, seed=99, lay=dv_layout),
        "minsum": float_llrs(1.0, 1024, seed=99, lay=dv_layout),
    }
    inputs["bp"] = inputs["minsum"]
    for kind in ("ib",) + rules:
        if kind == "ib":
            dec = HBMFusedIBDecoder(dv_layout, tables, early_exit=False)
            plain_decode = lambda: ib_lut_decode(
                dv_layout, dec.trellis(dev), inputs["ib"], early_exit=False
            )
        else:
            dec = HBMFloatDecoder(dv_layout, kind, max_iters=50, early_exit=False)
            plain_decode = lambda: plain[kind](dv_layout, inputs[kind], 50, early_exit=False)
        hbm_ms[kind] = cuda_ms(lambda: dec(inputs[kind]), reps=3)
        got = dec(inputs[kind])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = plain_decode()
        torch.cuda.synchronize()
        hbm_plain_ms[kind] = (time.perf_counter() - t0) * 1e3
        err = float((got.outputs - ref.outputs).abs().max())
        if kind == "ib":
            k3_err = max(k3_err, int(err))
        else:
            k4_err[kind] = max(k4_err[kind], err)
        if not same(got, ref):
            raise AssertionError(f"{kind} on the card disagrees with the plain decoder ({err})")
        print(f"[15 times] dvbs2 batch 1024 {kind} decode, 49 bodies: "
              f"{'K3' if kind == 'ib' else 'K4'} {hbm_ms[kind]:.3f} ms (tile "
              f"{dec.batch_tile}), plain whole-batch decoder {hbm_plain_ms[kind]:.1f} ms "
              f"on {card}; outputs equal", flush=True)
    # The cell's setting: early exit on. At 1.0 dB no tile leaves, so every
    # body pays its syndrome count and exit step.
    k4_ee = HBMFloatDecoder(dv_layout, "minsum", max_iters=50, early_exit=True)
    ee_ms = cuda_ms(lambda: k4_ee(inputs["minsum"]), reps=3)
    if float(k4_ee(inputs["minsum"]).iterations) != 49.0:
        raise AssertionError("a tile left early at 1.0 dB: the early-exit time is not of 49 bodies")
    print(f"[15 times] dvbs2 batch 1024 minsum decode, early exit on, 49 bodies (no tile leaves): "
          f"K4 {ee_ms:.3f} ms, {ee_ms / hbm_ms['minsum']:.3f} x early exit off on {card}", flush=True)
    profiled = {
        "K3": lambda: HBMFusedIBDecoder(dv_layout, tables, early_exit=False)(inputs["ib"]),
        "K4 minsum early exit": lambda: k4_ee(inputs["minsum"]),
        "K4 bp": lambda: HBMFloatDecoder(dv_layout, "bp", max_iters=50, early_exit=False)(inputs["bp"]),
    }
    for label, fn in profiled.items():
        passes = pass_times(fn)
        print(f"[15 passes] {label}, one decode: " + ", ".join(
            f"{k} {ms:.3f} ms / {n}" for k, (ms, n) in passes.items()) + f" (device ms / launches) on {card}",
            flush=True)
        if label == "K4 minsum early exit":
            n = {k: passes.get(k, (0.0, 0))[1] for k in PASS_KERNELS}
            if not n["cn"] == n["vn"] == n["exit"] == 49 or n["syndrome"] != 1:
                raise AssertionError(f"K4 with early exit launched {n}, not CN, exit and VN per body "
                                     "and one syndrome pass")
    # K4 min-sum's node-state passes against their device-memory bytes, at the
    # default slice and one other: a check record is 10 B, a total or a
    # channel LLR 4 B. CN: records read and written, T read once (its
    # gathers hit L2); VN: chs read, records read once, T written. The 49 CN
    # launches include body 0's, which reads chs in place of the records.
    n_checks, n_vars, batch = dv_layout.n_checks, dv_layout.n_vars, 1024
    pass_bytes = {"cn": (20 * n_checks + 4 * n_vars) * batch, "vn": (10 * n_checks + 8 * n_vars) * batch}
    for columns in (STATE_SLICE, STATE_SLICE // 2):
        dec = HBMFloatDecoder(dv_layout, "minsum", max_iters=50)
        dec.slice_columns = columns
        passes = pass_times(lambda: dec(inputs["minsum"]))
        body_ms = {k: passes[k][0] / passes[k][1] for k in pass_bytes}
        print(f"[15 state] K4 min-sum node state, slices of {state_slice(dec.batch_tile, columns)} columns, "
              "a body at batch 1024: " + ", ".join(
                  f"{k.upper()} {body_ms[k]:.4f} ms for {b / 1e9:.3f} GB of state "
                  f"({b / body_ms[k] / 1e6:.0f} GB/s, {b / body_ms[k] / 3.35e9 * 1e2:.1f}% of 3.35 TB/s)"
                  for k, b in pass_bytes.items()) + f" on {card}", flush=True)
    lap(15)

    # -- 16: K5 and K6 build (started in phase 2) ----------------------------
    k5_names = {
        "lookup1d": "lookup1d", "lookup2d_lanes": "lookup2d_lanes", "lookup2d": "lookup2d",
        "MinSumOp": "minsum_op",
        "BoxPlus": "boxplus", "AddClip": "float_mix", "3Min": "min", "hbm_copy": "copy",
    }
    for name, b in roof_builds.items():
        print(f"[16 build] {name}.cu: nvcc {b['seconds']:.2f} s (beside K1-K4); "
              f"{ptxas_lines(b['log'], k5_names)}", flush=True)
    # Each K5c op as compiled: its chain loop's SASS per application (one
    # fminf, FMNMX, per min-sum op, box-plus and min; two per add+clip),
    # by class against the roofline's count (FLOAT_OP_SASS).
    for op, (mangled, per_app) in K5C_LOOPS.items():
        ops = loop_op_counts(roof_builds["peaks"]["path"], mangled)
        apps = ops["FMNMX"] / per_app
        got = roofline.sass_counts({k: v / apps for k, v in ops.items()})
        want = roofline.FLOAT_OP_COUNTS[op]
        sass_equal = got.keys() == want.keys() and all(abs(got[k] - want[k]) < 1e-9 for k in got)
        b = roofline.bound(0, got)
        print(f"[16 sass] K5c {op} loop: {apps:.0f} applications a trip, per application "
              f"{json.dumps({k: round(v, 4) for k, v in got.items()})} by class "
              f"({'equal to' if sass_equal else 'NOT the'} roofline's count); busiest {b['busiest']}, "
              f"{b['compute_ms'] * 1e-3 * roofline.SMS * roofline.BOOST_HZ:.4f} SM-clocks an "
              f"application; opcodes "
              + json.dumps({k: round(v / apps, 4) for k, v in sorted(ops.items(), key=lambda kv: -kv[1])}),
              flush=True)
    lap(16)

    # -- 17: K5 and K6 against their plain versions ----------------------------
    primitives = [(kind, t) for kind in k5.LOOKUPS for t in (16, 32)]
    primitives += [(op, 0) for op in k5.FLOAT_OPS]
    rows = {}  # kernel record name -> its numbers
    for kind, t in primitives:
        threads = k5.threads_to_fill(kind, dev, t or 16)
        table, init = k5.chain_inputs(kind, threads, t or 16, seed=17)
        init = torch.as_tensor(init, device=dev)
        if table is None:
            run = lambda: k5.float_chain(kind, init, CHECK_LOOPS)
            plain_run = lambda: k5.float_chain_plain(kind, init, CHECK_LOOPS)
            ops = roofline.FLOAT_OP_COUNTS[kind]
        else:
            table = torch.as_tensor(table, device=dev)
            run = lambda: k5.lookup_chain(kind, table, init, CHECK_LOOPS)
            plain_run = lambda: k5.lookup_chain_plain(kind, table, init, CHECK_LOOPS)
            ops = {"lookup": 1}
        got = run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = plain_run()
        torch.cuda.synchronize()
        plain_ms_k = (time.perf_counter() - t0) * 1e3
        err = float((got.double() - want.double()).abs().max())
        if not bool((got == want).all()):
            raise AssertionError(f"K5 {kind} T={t} disagrees with its plain version ({err})")
        apps = threads * k5.CHAINS * k5.STEPS * CHECK_LOOPS
        moved = init.numel() * 4 + threads * 4 + (0 if table is None else table.numel())
        name = f"peaks_{k5.variant(kind, t)}"
        b = roofline.bound(moved, {k: apps * n for k, n in ops.items()})
        rows[name] = dict(
            max_abs_err=err, ms=cuda_ms(run, reps=5), plain_ms=plain_ms_k, library_ms=None,
            bound_ms=b["bound_ms"], bound_by=b["bound_by"],
        )
        print(f"[17 exact] K5 {name}: {threads} threads x {k5.CHAINS} chains x "
              f"{k5.STEPS * CHECK_LOOPS} steps equal to the plain version; kernel "
              f"{rows[name]['ms']:.3f} ms, plain {plain_ms_k:.1f} ms, bound "
              f"{rows[name]['bound_ms']:.4f} ms ({rows[name]['bound_by']}, busiest "
              f"{b['busiest']}), {rows[name]['bound_ms'] / rows[name]['ms']:.1%} of it on {card}",
              flush=True)
    src = torch.randint(-2**31, 2**31 - 1, (roofline.COPY_BYTES // 4,), dtype=torch.int32, device=dev)
    dst, ref_dst = torch.empty_like(src), torch.empty_like(src)
    hbm_copy.copy(src, dst)
    ref_dst.copy_(src)
    torch.cuda.synchronize()
    if not torch.equal(dst, ref_dst):
        raise AssertionError("K6 disagrees with copy_")
    ragged = torch.randint(0, 255, (roofline.COPY_BYTES + 12345,), dtype=torch.uint8, device=dev)
    ragged_dst = torch.zeros_like(ragged)
    hbm_copy.copy(ragged, ragged_dst)
    torch.cuda.synchronize()
    if not torch.equal(ragged, ragged_dst):
        raise AssertionError("K6 disagrees with copy_ on a size that is not a multiple of its chunk")
    print(f"[17 exact] K6 over {ragged.numel()} bytes ({ragged.numel() % hbm_copy.CHUNK_BYTES} past "
          f"the last {hbm_copy.CHUNK_BYTES}-byte chunk) equal to the source", flush=True)
    del ragged, ragged_dst
    rows["hbm_copy"] = dict(
        max_abs_err=0, plain_ms=cuda_ms(lambda: ref_dst.copy_(src)),
        ms=cuda_ms(lambda: hbm_copy.copy(src, dst)),
        library_ms=cuda_ms(lambda: ref_dst.copy_(src)),
        **{k: v for k, v in roofline.bound(2 * roofline.COPY_BYTES, {}).items()
           if k in ("bound_ms", "bound_by")},
    )
    print(f"[17 exact] K6 one 256 MB pass equal to copy_: kernel {rows['hbm_copy']['ms']:.4f} "
          f"ms, copy_ {rows['hbm_copy']['plain_ms']:.4f} and {rows['hbm_copy']['library_ms']:.4f} "
          f"ms, bound {rows['hbm_copy']['bound_ms']:.4f} ms (bytes) on {card}", flush=True)
    lap(17)

    # -- 18: peaks and bandwidth ---------------------------------------------------
    for kind, t in primitives:
        rate = peaks.primitive_peak(kind, t) if t else peaks.primitive_peak(kind)
        unit = "lookups" if t else "applications"
        b = roofline.bound(0, {"lookup": 1} if t else roofline.FLOAT_OP_COUNTS[kind])
        share = rate * b["compute_ms"] * 1e-3  # the per-pipe bound's time of one, over rate's
        print(f"[18 peak] {kind}{f' T={t}' if t else ''}: {rate / 1e9:.2f} G {unit}/s, "
              f"{share:.1%} of the per-pipe bound's rate (busiest {b['busiest']}) on {card}",
              flush=True)
    del src, dst, ref_dst
    bandwidth = roofline.traffic_bandwidth(dev)
    bw, copy_bw = bandwidth["k6"], bandwidth["copy_"]
    print(f"[18 bandwidth] K6 {bw / 1e9:.1f} GB/s, copy_ {copy_bw / 1e9:.1f} GB/s, data sheet "
          f"{roofline.DATA_SHEET_BYTES_PER_S / 1e9:.0f} GB/s ({bw / roofline.DATA_SHEET_BYTES_PER_S:.1%}) "
          f"on {card}", flush=True)
    if bw > 1.05 * roofline.DATA_SHEET_BYTES_PER_S:
        raise AssertionError(f"K6 reads {bw / 1e9:.1f} GB/s, above the data sheet: the byte count is wrong")
    lap(18)

    # -- 19: the regular (3,6) N=8000 code ----------------------------------------
    reg_tables = configs["regular_T16_1.05"].tables
    for rule in rules:
        ch = float_llrs(1.7, 4, seed=410, lay=reg_layout)
        dec = FusedFloatDecoder(reg_layout, rule, max_iters=50)
        got = dec(ch)
        ref = float_decode_tiled(reg_layout, ch, rule, dec.batch_tile, 50)
        torch.cuda.synchronize()
        if dec.batch_tile != 1 or not same(got, ref):
            raise AssertionError(f"K2 {rule} on regular N=8000 (tile {dec.batch_tile}) disagrees")
        print(f"[19 exact] K2 {rule} regular N=8000 1.7 dB batch 4 tile {dec.batch_tile}: outputs, "
              f"unsatisfied and mean iterations {float(got.iterations):.4f} equal", flush=True)
    reg_bands = [  # (decoder, Eb/N0, FER, BER, reference file)
        ("ib", 1.2, 0.626953125, 0.03899, "regular_ib_allzero"),
        ("minsum", 1.7, 0.6123046875, 0.03901, "regular_minsum"),
    ]
    for decoder_name, ebn0, fer_ref, ber_ref, ref_name in reg_bands:
        kw = dict(max_iters=50)
        if decoder_name == "ib":
            kw = dict(trellis=DeviceTrellis.from_tables(reg_tables, dev), cardinality_t_channel=16)
        sim = BERSimulator(reg_layout, decoder_name, device=dev, count_all_bits=True,
                           batch_per_device=1024, seed=0, backend="fused", **kw)
        sim.fused_decoder.launches = 0
        point = dispatch_point(sim, ebn0, DV_DISPATCHES)
        if sim.fused_decoder.launches != DV_DISPATCHES:
            raise AssertionError(f"{sim.fused_decoder.launches} launches for {DV_DISPATCHES} steps")
        fer_band, ber_band = ref_bands(point, fer_ref, ref_blocks=1024)
        print(f"[19 band] regular {decoder_name} ({type(sim.fused_decoder).__name__}, tile "
              f"{sim.fused_decoder.batch_tile}) {ebn0} dB over {point['blocks']} blocks: FER "
              f"{point['fer']:.5f} ({fer_ref} +- {fer_band:.5f}), BER {point['ber']:.6f} ({ber_ref} "
              f"+- {ber_band:.6f}, results/ber/{ref_name}.json), mean iterations "
              f"{point['iterations']:.3f}", flush=True)
        if abs(point["fer"] - fer_ref) > fer_band or abs(point["ber"] - ber_ref) > ber_band:
            raise AssertionError(f"regular {decoder_name} FER or BER at {ebn0} dB outside its band")
    lap(19)

    # -- 20: the benchmark matrix with its roofline ------------------------------------
    peaks._CACHE.clear()
    k5.launches.clear()
    hbm_copy.launches["hbm_copy"] = 0
    matrix = bench_matrix.main(["--out", str(Path("chiprun_out") / "BENCH_MATRIX.json")])
    roof_launches = {k5.variant(kind, t): k5.launches[k5.variant(kind, t)] for kind, t in primitives}
    roof_launches["hbm_copy"] = hbm_copy.launches["hbm_copy"]
    expected = {
        ("ib", "fused"): "FusedIBDecoder", ("ib", "hbm"): "HBMFusedIBDecoder",
        ("minsum", "fused"): "FusedFloatDecoder", ("bp", "fused"): "FusedFloatDecoder",
        ("minsum", "hbm"): "HBMFloatDecoder", ("ib", "xla"): "WholeBatchDecoder",
    }
    roof = matrix["roofline"]
    for name, sc in matrix["scenarios"].items():
        entry = roof[name]
        decodes = sc.get("kernel_launches", sc.get("whole_batch_calls"))
        print(f"[20 cell] {name}: {sc['coded_mbps']:.2f} Mbit/s coded, mean iterations "
              f"{sc['mean_iterations']:.2f}, backend {sc['backend']} ({sc['decoder_class']}, "
              f"{decodes} {'launches' if 'kernel_launches' in sc else 'whole-batch decodes'}), "
              f"bound {entry['bound']} {entry['speed_of_light_coded_mbps']:.1f} Mbit/s, fraction "
              f"{entry['fraction_of_sol']:.4f} on {card}", flush=True)
        if expected.get((sc["decoder"], sc["backend"])) != sc["decoder_class"] or not decodes:
            raise AssertionError(f"{name} ran {decodes} decodes through {sc['decoder_class']}")
        if entry["fraction_of_sol"] > 1:
            raise AssertionError(f"{name} beats its bound: fraction {entry['fraction_of_sol']:.3f}")
    missing = [k for k, n in roof_launches.items() if n == 0]
    if missing:
        raise AssertionError(f"the matrix launched no {missing}")
    print(f"[20 peaks] {json.dumps(roof['primitive_peaks_G_per_s'])} G/s; K6 "
          f"{roof['k6_copy_GBps']:.1f} GB/s, copy_ {roof['torch_copy_GBps']:.1f} GB/s, the bound "
          f"takes {roof['measured_hbm_bandwidth_GBps']:.1f}; launches {json.dumps(roof_launches)}",
          flush=True)
    matrix_bw = roof["measured_hbm_bandwidth_GBps"] * 1e9
    decode_shapes = {  # record name -> (layout, decoder, batch, bodies, tables)
        "ib_lut_fused": (layout, "ib", 4096, k1_iters, configs["wlan_T16_0.8"].tables),
        "float_fused_minsum": (layout, "minsum", 4096, 49.0, None),
        "float_fused_bp": (layout, "bp", 4096, 49.0, None),
        "ib_lut_hbm": (dv_layout, "ib", 1024, 49.0, configs["dvbs2_T16_0.6"].tables),
        "float_hbm_minsum": (dv_layout, "minsum", 1024, 49.0, None),
        "float_hbm_bp": (dv_layout, "bp", 1024, 49.0, None),
    }
    for name, (lay, decoder_name, batch, bodies, tables) in decode_shapes.items():
        b = roofline.decode_bound(lay, decoder_name, batch, bodies, tables)
        rows[name] = dict(library_ms=None, **{k: b[k] for k in ("bound_ms", "bound_by")})
        line = (f"[20 bound] {name} at batch {batch}, {bodies:.2f} bodies: I/O {b['io_ms']:.4f} ms, "
                f"compute {b['compute_ms']:.4f} ms (busiest {b['busiest']})")
        if "hbm" in name:
            traffic = roofline.view_bytes_per_body(lay, decoder_name, tables) * bodies * batch / matrix_bw
            line += f", device-memory traffic {traffic * 1e3:.3f} ms at the copy bandwidth"
        print(line + f" on {card}", flush=True)
    lap(20)

    k2_source = "informationbottleneckdecodingldpc_torch/csrc/float_fused.cu"
    k2_replaces = "informationbottleneckdecodingldpc_tpu/kernels/float_fused.py:143"
    records = [{
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
    } for rule in rules] + [{
        "name": "ib_lut_hbm",
        "route": "cuda",
        "source": "informationbottleneckdecodingldpc_torch/csrc/ib_lut_hbm.cu",
        "replaces": "informationbottleneckdecodingldpc_tpu/kernels/ib_lut_hbm.py:246",
        "launches": hbm_launches["ib"],
        "max_abs_err": k3_err,
        "ms": hbm_ms["ib"],
        "plain_ms": hbm_plain_ms["ib"],
    }] + [{
        "name": f"float_hbm_{rule}",
        "route": "cuda",
        "source": "informationbottleneckdecodingldpc_torch/csrc/float_hbm.cu",
        "replaces": "informationbottleneckdecodingldpc_tpu/kernels/float_hbm.py:139",
        "launches": hbm_launches[rule],
        "max_abs_err": k4_err[rule],
        "ms": hbm_ms[rule],
        "plain_ms": hbm_plain_ms[rule],
    } for rule in rules]
    for kind, t in primitives:
        name = f"peaks_{k5.variant(kind, t)}"
        records.append({
            "name": name,
            "route": "cuda",
            "source": "informationbottleneckdecodingldpc_torch/csrc/peaks.cu",
            "replaces": K5_REPLACES.get(kind, K5_REPLACES["float"]),
            "launches": roof_launches[k5.variant(kind, t)],
            **rows[name],
        })
    records.append({
        "name": "hbm_copy",
        "route": "cuda",
        "source": "informationbottleneckdecodingldpc_torch/csrc/hbm_copy.cu",
        "replaces": "scripts/bench_matrix.py:126",
        "launches": roof_launches["hbm_copy"],
        **rows["hbm_copy"],
    })
    records += probe_phases(dev, card, lap, probe_builds, bandwidth["copy_"])
    records += late_phases(dev, card, lap, late_builds, main_counts, hbm_ms["ib"] / 49, dv_layout)
    mary = mary_phases(dev, card, lap, layout, encoder, dv_layout, dv_encoder)
    # The M-ary path's launches (phases 31-32) join each kernel's count.
    mary_kernels = {"float_fused_minsum": "k2", "float_hbm_minsum": "k4",
                    "philox_planes_bits": "bits", "philox_planes_normal": "normal"}
    for r in records:
        r.update({k: v for k, v in rows.get(r["name"], {}).items() if k not in r})
        if r["name"] in mary_kernels:
            r["launches"] += mary["launches"][mary_kernels[r["name"]]]
            if r["name"] == "philox_planes_normal":
                r.pop("note", None)  # the M-ary chains' noise
    print(f"[mary] launches on the M-ary path: {json.dumps(dict(mary['launches']))}; QAM-16 "
          f"{mary['qam16_mbit_s']:.2f}, 8-PSK {mary['psk8_mbit_s']:.2f}, DVB-S2 QAM-16 "
          f"{mary['dvbs2_qam16_mbit_s']:.2f} Mbit/s coded on {card}", flush=True)
    # The data-parallel path's launches (phases 35, 36 and 38, counted in
    # their ranks and dispatches) join each kernel's count.
    parallel = parallel_phases(dev, card, lap, headline, layout, dv_codes)
    parallel_kernels = {"ib_lut_fused": "k1", "float_hbm_minsum": "k4",
                        "channel_input_uniform_clusters": "uniform_clusters",
                        "channel_input_uniform_llrs": "uniform_llrs"}
    for r in records:
        if r["name"] in parallel_kernels:
            r["launches"] += parallel[parallel_kernels[r["name"]]]
    print(f"[parallel] launches in phases 35, 36 and 38: {json.dumps(dict(parallel))}", flush=True)
    api = api_queue_phase(dev, card, lap, layout)
    for r in records:
        if r["name"] == "ib_lut_fused":
            r["launches"] += api["k1"]
        elif r["name"] == "philox_planes_uniform":
            r["launches"] += api["uniform"]
            r["note"] = ("its launches are the keyed samplers' (phase 39a); every engine step draws "
                         "its plane in registers (channel_input_*)")
    print(f"[api] launches in phase 39: {json.dumps(dict(api))}", flush=True)
    records += encoder_phase(dev, card, lap, encoder_launches)
    print(f"[total seconds] {time.perf_counter() - started:.1f}", flush=True)
    print(json.dumps({"kernels": [
        {k: r[k] for k in (*KERNEL_KEYS, "note") if k in r} for r in records
    ]}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
