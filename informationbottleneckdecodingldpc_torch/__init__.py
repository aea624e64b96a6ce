"""PyTorch and CUDA port of the Information-Bottleneck LDPC decoding framework.

A second package beside ``informationbottleneckdecodingldpc_tpu`` (the JAX
reference, which it is tested against bit for bit). It imports ``torch``,
``numpy`` and ``scipy`` and nothing of ``jax`` or of the JAX package: the
numpy host code it needs (``codes``, the ``ib`` quantizer, the host encoder,
the model zoo) is its own copy.

- ``codes``      check matrices (WLAN 802.11n, DVB-S2, regular and QC
                 constructions, alist/mat I/O) and Tanner graphs.
- ``ib``         the exact symmetric IB quantizer of the channel output and
                 the randomized sequential IB (``sib``).
- ``channel``    the AWGN channel, BPSK, square-QAM and M-PSK mapping and
                 transmitters, the exact soft demappers, the channel-output
                 quantizer tables, threshold quantization, inversion
                 sampling of channel clusters and their LLRs (from given
                 uniforms or a Philox key), and ``AWGNChannelQuantizer``,
                 which binds them on one device.
- ``construct``  decoder construction: discrete density evolution (regular
                 and irregular), message alignment (``matching``), the
                 trellis lookup tables, and saving and loading decoder
                 configs.
- ``decode``     degree-grouped decode layout, the plain whole-batch IB
                 lookup-table, min-sum and BP decoders, their loop, and the
                 factories that close over a layout and its tables.
- ``encode``     the host GF(2) encoder (numpy) and its device path.
- ``ops``        leave-one-out trellis folds with direct ``lut[a, b]``
                 lookups; min-sum, box-plus and variable-node float folds.
- ``kernels``    hand-written Hopper kernels (CUDA C++ under ``csrc/``) with
                 their plain PyTorch twins, built lazily at first CUDA use:
                 the IB and float decoders with views in shared memory
                 (``FusedIBDecoder``, ``make_fused_ib_decoder``,
                 ``FusedFloatDecoder``) or in device memory
                 (``HBMFusedIBDecoder``, ``HBMFloatDecoder``), the roofline's
                 peak microkernels (``peaks``) and copy (``hbm_copy``), the
                 probes P1-P6, and the Monte-Carlo engine's channel input
                 (``philox_planes``).
- ``sim``        Monte-Carlo BER engine for the all-zeros and encoded BPSK
                 chains and the M-ary chains, on the kernels or the
                 whole-batch decoders, with its per-codeword Philox draws
                 (``rng``); resumable Eb/N0 sweeps and their results files
                 and exports.
- ``parallel``   data parallelism over ``torch.distributed``: one process
                 per card, the counters all-reduced.
- ``models``     named codes with the port's decode layout, and decoder
                 configs built or loaded on demand.
- ``utils``      the headline, float-decoder, DVB-S2 and matrix scenarios,
                 the primitive peaks, the roofline, the probes' runners and
                 profiling helpers.
- ``cli``        command lines: the BER sweep (``simulate``), decoder
                 construction (``construct``), the results queue
                 (``queue``: configs, sweeps, extensions, matrix, report)
                 and its parity report (``parity_report``), the benchmark
                 matrix (``bench_matrix``), the kernels' times of a
                 checkout (``kernel_times``), the probes (``probes``), the
                 multi-process dry run (``dryrun``) and the IB early-exit
                 count (``ib_exit``).
"""

__version__ = "0.1.0"
