"""PyTorch and CUDA port of the Information-Bottleneck LDPC decoding framework.

A second package beside ``informationbottleneckdecodingldpc_tpu`` (the JAX
reference, which it is tested against bit for bit). It imports ``torch``,
``numpy`` and ``scipy`` and never ``jax``; from the JAX package it reuses only
the numpy host code of ``codes`` (Tanner graphs, code constructors), ``ib``
(the channel quantizer's IB clustering) and ``models.zoo`` (named codes).

- ``channel``    AWGN noise scale, the channel-output quantizer tables and
                 inversion sampling of channel clusters.
- ``construct``  trellis lookup tables and loading of constructed decoder
                 configs (construction itself stays in the JAX package).
- ``decode``     degree-grouped decode layout, the plain whole-batch IB
                 lookup-table decoder and its iteration loop.
- ``ops``        leave-one-out trellis folds with direct ``lut[a, b]`` lookups.
- ``kernels``    hand-written Hopper kernels (CUDA C++ under ``csrc/``) with
                 their plain PyTorch twins; built lazily at first CUDA use.
- ``sim``        Monte-Carlo BER engine for the all-zeros IB chain.
- ``models``     named codes with the port's decode layout.
- ``utils``      the headline throughput scenario.
- ``cli``        a reduced BER sweep command line.
"""

__version__ = "0.1.0"
