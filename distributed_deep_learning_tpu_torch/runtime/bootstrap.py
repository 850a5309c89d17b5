"""Process-group bootstrap: the port of
``distributed_deep_learning_tpu/runtime/bootstrap.py``.

The reference detects a distributed launch from ``OMPI_COMM_WORLD_*`` and
hard-codes its head node (``CNN/main.py:62-67,192-193``).  Here rank, world
and local rank come from a torchrun-style environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``: what ``--spawn`` sets, see :mod:`.launch`)
or from Open MPI's, and a run without either is world 1.  The rendezvous
is ``MASTER_ADDR``/``MASTER_PORT`` when the launcher gives them, else
loopback on a free port.  The backend is ``nccl`` on ``cuda`` and ``gloo``
on the CPU; each rank owns ``cuda:<local_rank>``, and ranks that outnumber
the visible cards raise (NCCL cannot give two ranks one card, and nothing
falls back to gloo or to the CPU).  A gloo default group that the caller
made before serves ``cuda`` too (gloo stages CUDA tensors through the
host): ranks that share a card that way each set ``LOCAL_RANK`` to it.
"""

from __future__ import annotations

import dataclasses
import os
import socket

import torch
import torch.distributed as dist

from distributed_deep_learning_tpu_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class DistEnv:
    """This process's place in the run."""

    rank: int = 0
    world: int = 1
    device: torch.device = torch.device("cpu")


def free_port() -> int:
    """A TCP port free on loopback right now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def env_topology() -> tuple[int, int, int]:
    """``(rank, world, local_rank)`` from a torchrun or Open MPI
    environment; ``(0, 1, 0)`` without one."""
    env = os.environ
    for rank, world, local in (("RANK", "WORLD_SIZE", "LOCAL_RANK"),
                               ("OMPI_COMM_WORLD_RANK",
                                "OMPI_COMM_WORLD_SIZE",
                                "OMPI_COMM_WORLD_LOCAL_RANK")):
        if world in env:
            return (int(env.get(rank, 0)), int(env[world]),
                    int(env.get(local, env.get(rank, 0))))
    return 0, 1, 0


def initialize(device: str = "cuda") -> tuple[DistEnv, bool]:
    """Idempotently initialise the default process group for ``device``
    (``cuda`` or ``cpu``).  Returns ``(env, created)``: ``created`` is True
    when this call made the group, so the caller destroys it (see
    :func:`shutdown`).  Raises when ``cuda`` is asked for without a card
    for this rank, or when an existing group's backend cannot serve
    ``device`` (an NCCL group on the CPU)."""
    kind = torch.device(device).type
    existing = dist.get_backend() if dist.is_initialized() else None
    backend = "nccl" if kind == "cuda" and existing != "gloo" else "gloo"
    rank, world, local = env_topology()
    if kind == "cuda":
        resolve_device("cuda")
        cards = torch.cuda.device_count()
        if local >= cards:
            raise RuntimeError(f"rank {rank} (local rank {local}) has no card"
                               f": {cards} visible; NCCL cannot give two "
                               "ranks one card (run at most one rank per "
                               "card)")
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    if existing is not None:
        if existing != backend:
            raise RuntimeError(f"a {existing} process group exists; -d "
                               f"{kind} needs {backend}")
        return DistEnv(dist.get_rank(), dist.get_world_size(), dev), False
    addr = os.environ.get("MASTER_ADDR", "127.0.0.1")
    port = os.environ.get("MASTER_PORT")
    if world > 1 and port is None:
        raise RuntimeError(f"world {world} without MASTER_PORT: the ranks "
                           "cannot find one another (set MASTER_ADDR and "
                           "MASTER_PORT, or launch with --spawn)")
    # device_id binds this rank's card to the group (NCCL's barrier and
    # communicators need not guess it from the rank)
    dist.init_process_group(backend,
                            init_method=f"tcp://{addr}:{port or free_port()}",
                            world_size=world, rank=rank,
                            device_id=dev if backend == "nccl" else None)
    return DistEnv(rank, world, dev), True


def shutdown() -> None:
    """Destroy the default process group (after :func:`initialize`
    created it)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def is_coordinator() -> bool:
    """Rank-0 gate for logging and writing (reference:
    ``verbose=rank==0``); True outside a process group."""
    return not dist.is_initialized() or dist.get_rank() == 0
