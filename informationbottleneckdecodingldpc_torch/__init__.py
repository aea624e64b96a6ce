"""PyTorch and CUDA port of the Information-Bottleneck LDPC decoding framework.

A second package beside ``informationbottleneckdecodingldpc_tpu`` (the JAX
reference, which it is tested against bit for bit). It imports ``torch``,
``numpy`` and ``scipy`` and nothing of ``jax`` or of the JAX package: the
numpy host code it needs (``codes``, the ``ib`` quantizer, the host encoder,
the model zoo) is its own copy.

- ``codes``      check matrices (WLAN 802.11n, DVB-S2, regular and QC
                 constructions, alist/mat I/O) and Tanner graphs.
- ``ib``         the exact symmetric IB quantizer of the channel output.
- ``channel``    the AWGN channel, BPSK, square-QAM and M-PSK mapping and
                 transmitters, the exact soft demappers, the channel-output
                 quantizer tables, threshold quantization and inversion
                 sampling of channel clusters and their LLRs.
- ``construct``  trellis lookup tables and loading of constructed decoder
                 configs (construction itself stays in the JAX package).
- ``decode``     degree-grouped decode layout, the plain whole-batch IB
                 lookup-table, min-sum and BP decoders and their loop.
- ``encode``     the host GF(2) encoder (numpy) and its device path.
- ``ops``        leave-one-out trellis folds with direct ``lut[a, b]``
                 lookups; min-sum, box-plus and variable-node float folds.
- ``kernels``    hand-written Hopper kernels (CUDA C++ under ``csrc/``) with
                 their plain PyTorch twins, built lazily at first CUDA use:
                 the IB and float decoders with views in shared memory
                 (``FusedIBDecoder``, ``FusedFloatDecoder``) or in device
                 memory (``HBMFusedIBDecoder``, ``HBMFloatDecoder``), and the
                 roofline's peak microkernels (``peaks``) and copy
                 (``hbm_copy``).
- ``sim``        Monte-Carlo BER engine for the all-zeros and encoded BPSK
                 chains and the M-ary chains, on the kernels or the
                 whole-batch decoders; resumable Eb/N0 sweeps and their
                 results files and exports.
- ``models``     named codes with the port's decode layout.
- ``utils``      the headline, float-decoder, DVB-S2 and matrix scenarios,
                 the primitive peaks, the roofline and profiling helpers.
- ``cli``        the BER sweep command line, the benchmark matrix, the
                 probes and the IB early-exit count.
"""

__version__ = "0.1.0"
