"""PyTorch and CUDA port of the Information-Bottleneck LDPC decoding framework.

A second package beside ``informationbottleneckdecodingldpc_tpu`` (the JAX
reference, which it is tested against bit for bit). It imports ``torch``,
``numpy`` and ``scipy`` and never ``jax``; from the JAX package it reuses only
the numpy host code of ``codes`` (Tanner graphs, code constructors), ``ib``
(the channel quantizer's IB clustering), ``models.zoo`` (named codes) and
``encode`` (the host GF(2) encoder).

- ``channel``    AWGN noise scale, BPSK mapping, the channel-output
                 quantizer tables, threshold quantization and inversion
                 sampling of channel clusters and their LLRs.
- ``construct``  trellis lookup tables and loading of constructed decoder
                 configs (construction itself stays in the JAX package).
- ``decode``     degree-grouped decode layout, the plain whole-batch IB
                 lookup-table, min-sum and BP decoders and their loop.
- ``encode``     the device GF(2) encoder of the encoded chain, on the JAX
                 package's numpy host encoder.
- ``ops``        leave-one-out trellis folds with direct ``lut[a, b]``
                 lookups; min-sum, box-plus and variable-node float folds.
- ``kernels``    hand-written Hopper kernels (CUDA C++ under ``csrc/``) with
                 their plain PyTorch twins, built lazily at first CUDA use:
                 the IB and float decoders with views in shared memory
                 (``FusedIBDecoder``, ``FusedFloatDecoder``) or in device
                 memory (``HBMFusedIBDecoder``, ``HBMFloatDecoder``).
- ``sim``        Monte-Carlo BER engine for the all-zeros and encoded BPSK
                 chains.
- ``models``     named codes with the port's decode layout.
- ``utils``      the headline, float-decoder and DVB-S2 throughput scenarios.
- ``cli``        a reduced BER sweep command line.
"""

__version__ = "0.1.0"
