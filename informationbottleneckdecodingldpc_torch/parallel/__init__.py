"""Data parallelism over ``torch.distributed``: one rank per card, the
counters all-reduced, the whole-batch decoders' early exit in lockstep."""

from .mesh import (
    DataMesh,
    initialize_multihost,
    make_mesh,
    psum_convergence_reduce,
    run_ranks,
)

__all__ = [
    "DataMesh",
    "initialize_multihost",
    "make_mesh",
    "psum_convergence_reduce",
    "run_ranks",
]
