"""Checkpoint / resume, torch-native: the port of
``distributed_deep_learning_tpu/utils/checkpoint.py`` without orbax.

A checkpoint of step ``s`` is one file, ``ckpt-<s>.pt``: the update count,
the f32 parameters, the optimizer's state and the dropout generator's
state of every rank (each rank draws its own masks), written to a
temporary file and renamed into place, so a step either exists whole or
not at all.  Beside it, written before it:

* ``manifest-<s>.json``: per-leaf CRC32, shape, dtype and finiteness of
  everything in the file; restores verify against it;
* ``extra-<s>.json`` (optional): the loader position and partial-phase
  totals of a mid-epoch save (:meth:`Checkpointer.read_extra`).

A save with ``wait=False`` is asynchronous, as the JAX package's orbax
save is by default (the training loop saves so; a direct call waits
unless told not to): :meth:`Checkpointer.save` takes a snapshot of the
state (on the card, a copy into pinned host memory on a side stream,
whose event the next in-place optimizer update waits for:
``TrainState.fence``), and a thread writes the sidecars, then the file,
from the snapshot.  :meth:`Checkpointer.wait_until_finished`
(every rank calls it) waits for the save in flight and re-raises its
error.  One save is in flight at a time: the next waits for it first.

:meth:`Checkpointer.restore_verified` falls back to the newest step that
verifies, quarantining (renaming under ``quarantine/``, never deleting) a
torn, bit-flipped or non-finite one.  A checkpointer ``shared`` by the
ranks of a process group (``-m data``): the ranks gather their generator
states, rank 0 writes and renames, every rank waits at a barrier after a
save, loads the same file and takes its own generator state; a
checkpoint of another world size is refused.  Otherwise (one process, or
a ``--no-sync`` rank training its own replica) the process writes and
reads its directory alone.
"""

from __future__ import annotations

import json
import os
import re
import sys
import threading
import zlib

import torch
import torch.distributed as dist

from distributed_deep_learning_tpu_torch.parallel.shards import (
    is_dtensor, is_split, local, local_part, resharded, whole, whole_shape)
from distributed_deep_learning_tpu_torch.train.state import TrainState
from distributed_deep_learning_tpu_torch.utils.config import ROADMAP_ITEMS

_CKPT = re.compile(r"ckpt-(\d+)\.pt")


class CheckpointCorruption(RuntimeError):
    """A checkpoint failed manifest verification."""

    def __init__(self, step: int, detail: str):
        self.step = step
        super().__init__(f"checkpoint step {step} failed integrity "
                         f"verification: {detail}")


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


class _OnCard:
    """A placeholder for the ``index``-th card tensor of a snapshot."""

    def __init__(self, index: int):
        self.index = index


def _side_stream(device) -> "torch.cuda.Stream":
    """The stream a snapshot copies on (a new one a save)."""
    return torch.cuda.Stream(device=device)


def _snapshot(obj):
    """``(host copy of obj, event)``: tensors on a card are copied into
    pinned host memory on a side stream that first waits for the current
    one, the event recorded after the last copy (None when nothing was on
    a card); the rest are copied on the host."""
    cuda = []

    def walk(o):
        if isinstance(o, torch.Tensor):
            if o.device.type == "cuda":
                cuda.append(o)
                return _OnCard(len(cuda) - 1)
            return o.detach().to("cpu", copy=True)
        if isinstance(o, dict):
            return {k: walk(v) for k, v in o.items()}
        if isinstance(o, (list, tuple)):
            return type(o)(walk(v) for v in o)
        return o

    tree = walk(obj)
    if not cuda:
        return tree, None
    side = _side_stream(cuda[0].device)
    side.wait_stream(torch.cuda.current_stream(cuda[0].device))
    hosts = []
    with torch.cuda.stream(side):
        for t in cuda:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t.detach(), non_blocking=True)
            t.record_stream(side)
            hosts.append(h)
        event = torch.cuda.Event()
        event.record(side)

    def fill(o):
        if isinstance(o, _OnCard):
            return hosts[o.index]
        if isinstance(o, dict):
            return {k: fill(v) for k, v in o.items()}
        if isinstance(o, (list, tuple)):
            return type(o)(fill(v) for v in o)
        return o

    return fill(tree), event


def _leaves(obj, prefix=""):
    """``(path, leaf)`` of a nested dict/list payload, in a fixed order."""
    if isinstance(obj, dict):
        for k in sorted(obj, key=str):
            yield from _leaves(obj[k], f"{prefix}/{k}")
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, obj


def leaf_records(payload) -> dict:
    """Per-leaf integrity records: CRC32 of a tensor's bytes with its
    shape, dtype and (floating point) finiteness; CRC32 of ``repr`` for a
    Python value."""
    records = {}
    for path, leaf in _leaves(payload):
        if isinstance(leaf, torch.Tensor):
            t = leaf.contiguous().reshape(-1)
            records[path] = {
                "crc32": zlib.crc32(t.view(torch.uint8).numpy()),
                "shape": list(leaf.shape), "dtype": str(leaf.dtype),
                "finite": bool(torch.isfinite(t).all())
                if t.is_floating_point() else True}
        else:
            records[path] = {"crc32": zlib.crc32(repr(leaf).encode())}
    return records


def is_sharded(state: TrainState) -> bool:
    """Whether ``state`` is split across ranks or holds a rank's own
    residual (saving it is collective)."""
    return hasattr(state.optimizer, "consolidate_state_dict") or \
        state.comm_residual is not None or _explicit(state) or any(
            is_split(p) for p in resharded(state.model).parameters())


def _explicit(state: TrainState) -> bool:
    """Whether ``--comm``'s :class:`..parallel.collectives.ExplicitFSDP`
    holds the state (its masters are this rank's shards)."""
    from distributed_deep_learning_tpu_torch.parallel.collectives import \
        ExplicitFSDP

    return isinstance(state.comm, ExplicitFSDP)


def whole_state_dict(model) -> dict:
    """``model``'s state dict with every split parameter whole (every
    rank calls it)."""
    params = dict(resharded(model).named_parameters())
    return {k: whole(params[k], v) if k in params and is_split(params[k])
            else v for k, v in model.state_dict().items()}


def _whole_optimizer(optimizer, writer: bool):
    """The optimizer's state dict with every split moment whole (the
    writer's; None elsewhere for ZeRO-1, whose state consolidates on its
    group's first rank)."""
    if hasattr(optimizer, "consolidate_state_dict"):
        group = optimizer.process_group
        optimizer.consolidate_state_dict(to=dist.get_global_rank(group, 0))
        return optimizer.state_dict() if writer else None
    sd = optimizer.state_dict()
    params = [p for g in optimizer.param_groups for p in g["params"]]
    state = {}
    for i in sorted(sd["state"]):
        p = params[i]
        state[i] = {k: _whole_moment(p, v)
                    for k, v in sd["state"][i].items()}
    return {**sd, "state": state}


def _whole_moment(p, v):
    if not (isinstance(v, torch.Tensor) and is_split(p)):
        return v
    if is_dtensor(v):
        return v.full_tensor()
    if v.shape == local(p).shape and tuple(v.shape) != whole_shape(p):
        return whole(p, v)
    return v           # a statistic of the whole parameter already


def state_payload(state: TrainState, generators=None, *,
                  writer: bool = True, host: bool = True) -> dict | None:
    """What a checkpoint holds, on the host (``host=False``: where it
    lies, the buffers copied so that the next forward cannot change
    them).  ``generators``: every rank's dropout generator state,
    in rank order (default: this process's).  For sharded state every
    rank calls it (it gathers); the ``writer`` gets the payload, the
    others None."""
    if generators is None and state.generator is not None:
        generators = [state.generator.get_state()]
    finish = _to_cpu if host else (lambda p: p)
    if not is_sharded(state):
        return finish(_with_sentinel(state, {
            "step": int(state.step),
            "params": _buffers_copied(state.model,
                                      state.model.state_dict()),
            "optimizer": state.optimizer.state_dict(),
            "generator": generators}))
    from distributed_deep_learning_tpu_torch.parallel.collectives import \
        gather_residual

    if _explicit(state):
        state.comm.gather(exact=True)
        params = state.model.state_dict()
        optimizer = state.comm.whole_optimizer(state.optimizer, writer)
    else:
        params = whole_state_dict(state.model)
        optimizer = _whole_optimizer(state.optimizer, writer)
    residual = gather_residual(state)
    if not writer:
        return None
    payload = {"step": int(state.step),
               "params": _buffers_copied(state.model, params),
               "optimizer": optimizer, "generator": generators}
    if residual is not None:
        # every batch rank's, on a leading axis (n, ...), as JAX holds it
        payload["comm_residual"] = residual
    return finish(_with_sentinel(state, payload))


def _buffers_copied(model, params: dict) -> dict:
    """``params`` (a state dict) with the model's buffers copied: a
    forward updates them in place (BatchNorm)."""
    names = {n for n, _ in model.named_buffers()}
    return {k: v.clone() if k in names else v for k, v in params.items()}


def _with_sentinel(state: TrainState, payload: dict) -> dict:
    """``payload`` with the anomaly sentinel's four scalars, when the
    state has a sentinel."""
    if state.sentinel is not None:
        payload["sentinel"] = state.sentinel.to_dict()
    return payload


def _load_params(model, sd: dict) -> None:
    params = dict(resharded(model).named_parameters())
    if not any(is_split(p) for p in params.values()):
        model.load_state_dict(sd)
        return
    buffers = dict(model.named_buffers())
    if set(sd) != set(params) | set(buffers):
        raise ValueError(f"checkpoint parameters {sorted(set(sd))} do not "
                         f"match the model's {sorted(params)}")
    with torch.no_grad():
        for k, p in params.items():
            v = sd[k].to(local(p).device, local(p).dtype)
            local(p).copy_(local_part(p, v) if is_split(p) else v)
        for k, b in buffers.items():
            b.copy_(sd[k])


def _load_optimizer(optimizer, sd: dict) -> None:
    """Load whole moments into this run's layout: a split parameter's
    moment becomes its local part (a DTensor where the optimizer keeps
    DTensor state, ``Adafactor``'s whole statistics as they are)."""
    if hasattr(optimizer, "consolidate_state_dict"):
        optimizer.load_state_dict(sd)
        return
    from torch.distributed.tensor import DTensor

    params = [p for g in optimizer.param_groups for p in g["params"]]
    keep_whole = getattr(optimizer, "whole_state", False)
    local_state = getattr(optimizer, "local_state", False)
    state = {}
    for i, st in sd["state"].items():
        p = params[int(i)]
        state[i] = {}
        for k, v in st.items():
            if isinstance(v, torch.Tensor) and is_split(p) and \
                    not keep_whole and tuple(v.shape) == whole_shape(p):
                part = local_part(p, v.to(local(p).device))
                if is_dtensor(p) and not local_state:
                    part = DTensor.from_local(part, p.device_mesh,
                                              p.placements, shape=p.shape,
                                              stride=p.stride())
                v = part
            state[i][k] = v
    optimizer.load_state_dict({**sd, "state": state})


def load_payload(state: TrainState, payload: dict, *, rank: int = 0,
                 world: int = 1) -> TrainState:
    """Copy a checkpoint's contents into ``state`` (in place), the dropout
    generator from the state that ``rank`` of ``world`` saved.  Raises
    ``ValueError`` when the checkpoint and the run disagree on dropout or
    on the number of ranks that draw masks."""
    gens = payload["generator"]
    if (gens is None) != (state.generator is None):
        raise ValueError("checkpoint and run disagree on dropout: one has a "
                         "dropout generator and the other none")
    if gens is not None and len(gens) != world:
        raise ValueError(f"checkpoint holds the dropout streams of "
                         f"{len(gens)} rank(s), this run has {world}: "
                         "resume at the world size that saved it")
    if (payload.get("comm_residual") is None) != \
            (state.comm_residual is None):
        raise ValueError("checkpoint and run disagree on the int8 "
                         "error-feedback residual (--comm int8 / "
                         "--grad-compress int8 on more than one rank)")
    if _explicit(state):
        state.comm.load(payload["params"], state.optimizer,
                        payload["optimizer"])
    else:
        _load_params(state.model, payload["params"])
        _load_optimizer(state.optimizer, payload["optimizer"])
    if state.comm_residual is not None:
        from distributed_deep_learning_tpu_torch.parallel.collectives \
            import load_residual

        load_residual(state, payload["comm_residual"])
    state.step = int(payload["step"])
    if gens is not None:
        state.generator.set_state(gens[rank])
    if state.sentinel is not None and "sentinel" in payload:
        from distributed_deep_learning_tpu_torch.train.sentinel import \
            SentinelState

        state.sentinel = SentinelState.from_dict(payload["sentinel"])
    return state


class Checkpointer:
    """Checkpoints of one run directory, the newest ``keep`` kept.
    ``replicated_generator``: the ranks share one dropout stream (the
    pipeline grid's, whose ranks draw the same step seed), so a
    checkpoint holds it once and restores at any world size."""

    def __init__(self, directory: str | os.PathLike, *, keep: int = 3,
                 shared: bool = True, topology: dict | None = None,
                 replicated_generator: bool = False,
                 publish_dir: str | None = None):
        self._dir = os.path.abspath(os.fspath(directory))
        self.keep = keep
        #: ``--publish-weights``: every save's params are also published
        #: here (:func:`..serve.reload.publish_weights`) once the save is
        #: durable, for serving engines watching it (``--reload-watch``);
        #: process 0 publishes (ranks that keep their own replicas too)
        self.publish_dir = publish_dir if (
            not dist.is_initialized() or dist.get_rank() == 0) else None
        self.topology = topology
        self.replicated_generator = replicated_generator
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self._shared = shared and dist.is_initialized()
        self._rank, self._world = (
            (dist.get_rank(), dist.get_world_size()) if self._shared
            else (0, 1))
        self._writer = self._rank == 0
        if self._writer:
            os.makedirs(self._dir, exist_ok=True)
        self._barrier()

    def _barrier(self) -> None:
        if self._shared:
            dist.barrier()

    def _generator_states(self, state: TrainState):
        """Every rank's dropout generator state, in rank order (one
        collective when shared), or None without dropout."""
        if state.generator is None:
            return None
        mine = state.generator.get_state()
        if not self._shared or self.replicated_generator:
            return [mine]
        states = [None] * self._world
        dist.all_gather_object(states, mine)
        return states

    def _path(self, kind: str, step: int) -> str:
        ext = "pt" if kind == "ckpt" else "json"
        return os.path.join(self._dir, f"{kind}-{step}.{ext}")

    # -- save ---------------------------------------------------------------
    def save(self, step: int, state: TrainState, *,
             extra: dict | None = None, wait: bool = True) -> bool:
        """Persist ``state`` under ``step``; with ``wait=False``
        asynchronously: the collective part (gathers) and the snapshot run
        here, the writing on a thread (see the module docstring).  A step
        that exists is skipped, not rewritten (a run never reuses a dirty
        directory without ``--resume`` or ``--elastic``, so a replayed id
        holds identical state).  ``extra`` is the small JSON sidecar.
        Returns whether it saved."""
        self.wait_until_finished()
        generators = self._generator_states(state)
        if step in self.all_steps():
            self._barrier()
            return False
        payload = None
        if self._writer or is_sharded(state):
            payload = state_payload(state, generators, writer=self._writer,
                                    host=False)
        if self._writer:
            payload, event = _snapshot(payload)
            if event is not None:
                state.fence = event
            self._thread = threading.Thread(
                target=self._write, args=(step, payload, event, extra),
                name=f"checkpoint-{step}", daemon=True)
            self._thread.start()
        if wait:
            self.wait_until_finished()
        return True

    def _write(self, step: int, payload: dict, event, extra) -> None:
        """The writer thread: the sidecars, then the file under a
        temporary name renamed into place."""
        try:
            if event is not None:
                event.synchronize()
            if extra is not None:
                self._write_json(self._path("extra", step), extra)
            records = leaf_records(payload)
            manifest = {"format": 1,
                        "all_finite": all(r.get("finite", True)
                                          for r in records.values()),
                        "leaves": records}
            if self.topology is not None:
                manifest["topology"] = self.topology
            self._write_json(self._path("manifest", step), manifest)
            path = self._path("ckpt", step)
            tmp = f"{path}.tmp.{os.getpid()}"
            torch.save(payload, tmp)
            os.replace(tmp, path)                 # atomic on POSIX
            if self.publish_dir is not None:
                # durability gate: only weights a restart could also
                # restore are offered to live engines
                from distributed_deep_learning_tpu_torch.serve.reload import \
                    publish_weights
                publish_weights(self.publish_dir, step, payload["params"])
            self._collect(newest=step)
        except BaseException as e:  # noqa: BLE001 - re-raised on wait
            self._error = e

    def wait_until_finished(self) -> None:
        """Wait for the save in flight (every rank calls it: the ranks
        then see the same steps) and re-raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def close(self) -> None:
        self.wait_until_finished()

    def __enter__(self) -> "Checkpointer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @staticmethod
    def _write_json(path: str, payload: dict) -> None:
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)

    def _collect(self, newest: int) -> None:
        """Drop all but the newest ``keep`` steps, and sidecars orphaned
        below ``newest`` (a kill between a sidecar and its step)."""
        steps = self.all_steps()
        keep = set(steps[-self.keep:])
        for name in os.listdir(self._dir):
            m = re.fullmatch(r"(ckpt|extra|manifest)-(\d+)\.(pt|json)", name)
            if m and int(m.group(2)) not in keep \
                    and int(m.group(2)) < newest:
                os.remove(os.path.join(self._dir, name))

    # -- read ---------------------------------------------------------------
    def all_steps(self) -> list[int]:
        """Step ids with a finished checkpoint file, ascending."""
        if not os.path.isdir(self._dir):
            return []
        return sorted(int(m.group(1)) for m in map(_CKPT.fullmatch,
                                                   os.listdir(self._dir))
                      if m)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _read_json(self, kind: str, step: int | None) -> dict | None:
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        try:
            with open(self._path(kind, step)) as f:
                return json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return None

    def read_extra(self, step: int | None = None) -> dict | None:
        """The ``extra`` sidecar of ``step`` (default: latest), or None."""
        return self._read_json("extra", step)

    def read_manifest(self, step: int | None = None) -> dict | None:
        """The integrity manifest of ``step`` (default: latest), or None."""
        return self._read_json("manifest", step)

    # -- restore ------------------------------------------------------------
    def load(self, step: int) -> dict:
        """The payload of ``step``, checked against its manifest (raises
        :class:`CheckpointCorruption`; a torn file raises from
        ``torch.load``)."""
        payload = torch.load(self._path("ckpt", step), map_location="cpu",
                             weights_only=True)
        self._verify(step, payload)
        return payload

    def restore(self, state: TrainState,
                step: int | None = None) -> TrainState | None:
        """Load ``step`` (default: latest), verified, into ``state``; None
        when the directory holds no checkpoint."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        return self._into(state, self.load(step), step)

    def _into(self, state: TrainState, payload: dict,
              step: int) -> TrainState:
        saved = (self.read_manifest(step) or {}).get("topology")
        if saved is not None and self.topology is not None and \
                saved != self.topology:
            raise ValueError(
                f"checkpoint step {step} was saved under {saved}, this run "
                f"is {self.topology}: restoring it into another layout is "
                f"--reshard's, not ported yet: {ROADMAP_ITEMS[14]}")
        if self.replicated_generator:
            return load_payload(state, payload)
        return load_payload(state, payload, rank=self._rank,
                            world=self._world)

    def _verify(self, step: int, payload: dict) -> None:
        manifest = self.read_manifest(step)
        if manifest is None:
            raise CheckpointCorruption(step, "missing or unreadable "
                                       "manifest")
        if not manifest.get("all_finite", True):
            raise CheckpointCorruption(
                step, "manifest records non-finite values at save time")
        expected, actual = manifest.get("leaves", {}), leaf_records(payload)
        if set(expected) != set(actual):
            raise CheckpointCorruption(
                step, f"leaf set changed: manifest has {len(expected)} "
                f"leaves, the file {len(actual)}")
        for key, rec in expected.items():
            if rec["crc32"] != actual[key]["crc32"]:
                raise CheckpointCorruption(step, f"checksum mismatch at "
                                           f"leaf {key!r}")
            if not actual[key].get("finite", True):
                raise CheckpointCorruption(step, f"non-finite values at "
                                           f"leaf {key!r}")

    def restore_verified(self, state: TrainState, step: int | None = None
                         ) -> tuple[TrainState | None, int | None]:
        """Restore the newest step at or below ``step`` that verifies.  A
        step that fails to load or to verify is quarantined and the next
        older one tried.  Returns ``(state, step)``, or ``(None, None)``
        when none survives.  Every rank calls it; a save in flight is
        finished first."""
        self.wait_until_finished()
        candidates = sorted((s for s in self.all_steps()
                             if step is None or s <= step), reverse=True)
        try:
            for s in candidates:
                try:
                    payload = self.load(s)
                # a torn file fails inside torch.load with whatever its
                # reader raises; any failure makes the step unusable
                except Exception as e:  # noqa: BLE001
                    print(f"checkpoint: step {s} unusable "
                          f"({type(e).__name__}: {e}); quarantining and "
                          "falling back", file=sys.stderr, flush=True)
                    self.quarantine(s, reason=f"{type(e).__name__}: {e}")
                    continue
                # a step that verifies but does not fit the run (dropout,
                # world size) is the run's fault, not the step's: it raises
                return self._into(state, payload, s), s
            return None, None
        finally:
            self._barrier()

    # -- quarantine ---------------------------------------------------------
    def quarantine(self, step: int, reason: str = "") -> str | None:
        """Move ``step``'s file and sidecars under ``<dir>/quarantine/``
        (the writer; rename, never delete: the bad file is evidence).
        Returns the new path of the checkpoint file."""
        if not self._writer:
            return None
        src = self._path("ckpt", step)
        if not os.path.exists(src):
            return None
        qdir = os.path.join(self._dir, "quarantine")
        os.makedirs(qdir, exist_ok=True)
        base, n = os.path.basename(src), 0
        while os.path.exists(os.path.join(qdir, base)):
            n += 1
            base = f"{os.path.basename(src)}.{n}"
        dst = os.path.join(qdir, base)
        os.rename(src, dst)
        for kind in ("extra", "manifest"):
            side = self._path(kind, step)
            if os.path.exists(side):
                os.rename(side, f"{dst}-{os.path.basename(side)}")
        if reason:
            self._write_json(f"{dst}.reason.json",
                             {"step": step, "reason": reason})
        return dst
