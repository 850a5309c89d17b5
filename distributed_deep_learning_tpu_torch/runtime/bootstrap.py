"""Process-group bootstrap: the port of
``distributed_deep_learning_tpu/runtime/bootstrap.py``.

The reference detects a distributed launch from ``OMPI_COMM_WORLD_*`` and
hard-codes its head node (``CNN/main.py:62-67,192-193``).  Here rank, world
and local rank come from a torchrun-style environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``: what ``--spawn`` sets, see :mod:`.launch`)
or from Open MPI's, and a run without either is world 1.  The rendezvous
is ``MASTER_ADDR``/``MASTER_PORT`` when the launcher gives them, else a
store on a loopback port the OS picks.  A launcher that holds the store
itself (:func:`host_store`, what ``--spawn`` does) sets ``DDL_HOSTED_STORE``
and every rank joins it as a client, so the port is bound from the moment
it is chosen and two launches never share one; otherwise rank 0 binds
``MASTER_PORT``.  A rendezvous that does not complete within
:data:`RENDEZVOUS_TIMEOUT` raises, naming its address and port.  The
backend is ``nccl`` on ``cuda`` and ``gloo`` on the CPU; each rank owns
``cuda:<local_rank>``, and ranks that outnumber the visible cards raise
(NCCL cannot give two ranks one card, and nothing falls back to gloo or
to the CPU).  A gloo default group that the caller
made before serves ``cuda`` too (gloo stages CUDA tensors through the
host): ranks that share a card that way each set ``LOCAL_RANK`` to it.
"""

from __future__ import annotations

import dataclasses
import datetime
import itertools
import os

import torch
import torch.distributed as dist

from distributed_deep_learning_tpu_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class DistEnv:
    """This process's place in the run."""

    rank: int = 0
    world: int = 1
    device: torch.device = torch.device("cpu")


#: seconds a rank waits for its rendezvous (the store's connection and the
#: group's first exchange of addresses) before it raises.  A rank reaches
#: it seconds after its launch (torch's import, the card's context); 180 s
#: leaves an order of magnitude more for a host loaded with other runs,
#: and stays below the 240 s within which the CPU tests expect a two-rank
#: run to end, so a broken rendezvous shows as the ranks' own error.  The
#: collectives keep torch's default timeout: a peer may legitimately spend
#: minutes in a save or a kernel build.
RENDEZVOUS_TIMEOUT = 180.0

#: set to 1 by a launcher that holds the rendezvous store at
#: ``MASTER_ADDR``/``MASTER_PORT`` (:func:`host_store`)
HOSTED = "DDL_HOSTED_STORE"

_hosted_joins = itertools.count()


def _timeout() -> datetime.timedelta:
    return datetime.timedelta(seconds=RENDEZVOUS_TIMEOUT)


def host_store() -> dist.TCPStore:
    """A rendezvous store on a loopback port the OS picks, held by the
    calling process (a launcher) for as long as it keeps the object: its
    ``port`` goes to the ranks as ``MASTER_PORT``, with ``DDL_HOSTED_STORE=1``
    (:func:`hosted_env`), and each joins it as a client."""
    return dist.TCPStore("127.0.0.1", 0, is_master=True,
                         wait_for_workers=False, timeout=_timeout())


def hosted_env(store: dist.TCPStore) -> dict:
    """The environment that sends a rank to ``store``."""
    return {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(store.port),
            HOSTED: "1"}


def join(backend: str, rank: int, world: int, *, addr: str | None = None,
         port: int | str | None = None, device_id=None) -> None:
    """Make the default process group of ``world`` ranks through a store:
    the launcher's (``DDL_HOSTED_STORE=1``: every rank a client, each of
    this process's groups under its own key prefix), else one that rank 0
    binds at ``addr:port`` (``port`` None: one the OS picks, world 1
    only).  Raises ``RuntimeError`` naming ``addr:port`` when the
    rendezvous fails or takes longer than :data:`RENDEZVOUS_TIMEOUT`."""
    addr = addr or os.environ.get("MASTER_ADDR", "127.0.0.1")
    port = os.environ.get("MASTER_PORT") if port is None else port
    limit = _timeout()
    hosted = os.environ.get(HOSTED) == "1"
    where = f"tcp://{addr}:{port}"
    try:
        store = dist.TCPStore(addr, int(port or 0),
                              is_master=rank == 0 and not hosted,
                              wait_for_workers=False, timeout=limit)
        if hosted:
            store = dist.PrefixStore(f"ddl{next(_hosted_joins)}/", store)
        where = f"tcp://{addr}:{port or store.port}"
        dist.init_process_group(backend, store=store, world_size=world,
                                rank=rank, timeout=limit,
                                device_id=device_id)
    except (RuntimeError, dist.DistError) as e:
        raise RuntimeError(
            f"rank {rank} of {world}: rendezvous at {where} failed within "
            f"{limit.total_seconds():g} s ({type(e).__name__}: "
            f"{str(e).splitlines()[0] if str(e) else ''})") from e
    # met: the collectives and later groups' exchanges get torch's defaults
    from torch.distributed import constants, distributed_c10d

    later = (constants.default_pg_nccl_timeout if backend == "nccl"
             else None) or constants.default_pg_timeout
    store.set_timeout(later)
    distributed_c10d._set_pg_timeout(later)


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
    device_id = dev if backend == "nccl" else None
    if os.environ.get("TORCHELASTIC_USE_AGENT_STORE") == "True":
        # torchrun's agent holds the store; torch's own rendezvous joins it
        dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}",
                                world_size=world, rank=rank,
                                device_id=device_id)
    else:
        join(backend, rank, world, addr=addr, port=port,
             device_id=device_id)
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
