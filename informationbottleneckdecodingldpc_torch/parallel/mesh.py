"""Data parallelism over ``torch.distributed``: one rank per card.

Port of ``parallel/mesh.py``. The JAX package runs one process over a mesh
of devices with the codeword batch sharded on axis ``'data'``; in PyTorch
each card is driven by a process of its own, so the mesh is the world of
ranks of one process group. Rank ``r`` of ``world`` decodes codewords
``[r B, (r + 1) B)`` of each Monte-Carlo step's global batch of ``B world``
(the draws are keyed by the global codeword index, ``sim/rng.py``), the
counters are all-reduced once per dispatch, and the whole-batch decoders'
early-exit test all-reduces the count of unconverged codewords after every
body, so every rank runs the same bodies (:func:`psum_convergence_reduce`).

The backend follows the device: ``nccl`` for CUDA, ``gloo`` for the CPU. A
caller may name ``gloo`` for CUDA tensors (two ranks sharing one card, which
NCCL refuses); collectives then run on host copies. Nothing falls back to
another backend or device: a group that fails to initialise raises, and a
rank that dies makes the others fail after :data:`TIMEOUT`.
"""

from __future__ import annotations

import dataclasses
import datetime
import subprocess
import sys
from typing import Callable

import torch
import torch.distributed as dist

# How long a collective or the group's rendezvous waits for the other ranks.
TIMEOUT = datetime.timedelta(seconds=120)


def default_backend(device: torch.device | str) -> str:
    """``nccl`` for a CUDA device, ``gloo`` for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
) -> tuple[int, int]:
    """Join the process group: ``torch.distributed.init_process_group`` over
    ``tcp://<coordinator_address>`` with ``num_processes`` ranks, this one
    ``process_id``, or, with no address, from the environment
    (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``).
    ``backend`` defaults to ``nccl`` when a card is present and ``gloo``
    otherwise; a caller with a device passes :func:`default_backend` of it.

    Returns (rank, world size). A second call is a no-op."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if backend is None:
        backend = default_backend("cuda" if torch.cuda.is_available() else "cpu")
    kw = {}
    if num_processes is not None:
        kw["world_size"] = int(num_processes)
    if process_id is not None:
        kw["rank"] = int(process_id)
    init_method = f"tcp://{coordinator_address}" if coordinator_address else "env://"
    dist.init_process_group(backend, init_method=init_method, timeout=TIMEOUT, **kw)
    return dist.get_rank(), dist.get_world_size()


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """The 1-D data mesh (the JAX package's axis ``'data'``) of this process: its rank,
    the world size, the process group (None when no group is initialised:
    one rank, no collectives) and the rank's device."""

    rank: int
    world: int
    group: dist.ProcessGroup | None
    device: torch.device

    @property
    def comm_device(self) -> torch.device:
        """Where this group's collectives take their tensors: the rank's card
        under NCCL, the host under gloo."""
        if self.group is not None and dist.get_backend(self.group) == "nccl":
            return self.device
        return torch.device("cpu")

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks, on :attr:`comm_device` (``t``
        itself, on its device, when there is no group)."""
        if self.group is None:
            return t
        t = t.to(self.comm_device)
        dist.all_reduce(t, group=self.group)
        return t

    def broadcast_bytes(self, payload: bytes) -> bytes:
        """Rank 0's ``payload`` on every rank, as length-prefixed uint8 (the
        other ranks' ``payload`` is ignored)."""
        if self.group is None:
            return payload
        n = torch.tensor([len(payload)], dtype=torch.int64, device=self.comm_device)
        dist.broadcast(n, src=0, group=self.group)
        buf = torch.zeros(int(n), dtype=torch.uint8, device=self.comm_device)
        if self.rank == 0 and payload:
            buf.copy_(torch.frombuffer(bytearray(payload), dtype=torch.uint8))
        dist.broadcast(buf, src=0, group=self.group)
        return bytes(buf.cpu().numpy())


def make_mesh(n_devices: int | None = None, device: torch.device | str = "cpu") -> DataMesh:
    """The data mesh of this process on ``device``: the initialised process
    group, or one rank without collectives when there is none.

    ``n_devices`` None takes the group's size; any other value must equal it
    (one process per card), else ``ValueError``."""
    if dist.is_initialized():
        rank, world, group = dist.get_rank(), dist.get_world_size(), dist.group.WORLD
    else:
        rank, world, group = 0, 1, None
    if n_devices is not None and int(n_devices) != world:
        held = (f"the process group holds {world} ranks" if group is not None
                else "no process group is set up")
        raise ValueError(
            f"n_devices={n_devices}, but {held}: launch one process per card "
            "(initialize_multihost) and pass n_devices=None or the world size"
        )
    return DataMesh(rank=rank, world=world, group=group, device=torch.device(device))


def psum_convergence_reduce(mesh: DataMesh) -> Callable[[torch.Tensor], torch.Tensor]:
    """The lockstep early-exit test of the whole-batch decoders: maps the
    per-codeword unconverged flags of this rank to their count over all
    ranks, so every rank leaves the loop after the same body."""

    def reduce(u: torch.Tensor) -> torch.Tensor:
        return mesh.all_reduce(u.sum(dtype=torch.int64))

    return reduce


def run_ranks(world: int, argv: list[str], timeout: float, env: dict | None = None) -> str:
    """Run ``world`` ranks of ``python <argv>`` under ``torch.distributed.run
    --standalone`` and return their standard output (lines of all ranks, in
    the order written). Each rank is a fresh process (never a fork of one
    that may hold a CUDA context) with ``RANK``, ``LOCAL_RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT`` set, so it joins the
    group through :func:`initialize_multihost` with no address. A rank that
    exits non-zero (the launcher then stops the others), or a run longer
    than ``timeout`` seconds (the launcher is told to stop its ranks),
    raises ``RuntimeError`` with the tail of the ranks' error output."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={world}", *argv]
    with subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                          env=env) as p:
        try:
            out, err = p.communicate(timeout=timeout)
            why = f"exited {p.returncode}" if p.returncode else None
        except subprocess.TimeoutExpired:
            why = f"timed out after {timeout} s"
            p.terminate()  # the launcher stops its ranks (SIGTERM, then SIGKILL), then exits
            try:
                out, err = p.communicate(timeout=TIMEOUT.total_seconds())
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
                err = "(the launcher did not stop)"
    if why:
        raise RuntimeError(f"{world} rank(s) of {' '.join(argv)}: {why}\n{err[-6000:]}")
    return out
