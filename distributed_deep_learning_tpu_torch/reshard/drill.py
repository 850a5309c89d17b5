"""The shrink drill: kill K of N workers, re-plan, reshard, continue.
The port of ``distributed_deep_learning_tpu/reshard/drill.py``, over
gloo ranks on the CPU (each a process, as the port runs one a rank):

1. ``n_devices`` ranks train ``mlp -m data --zero 1`` for one epoch
   (ZeRO-1 sharded optimizer state), checkpointing at the epoch boundary
   (topology manifest included);
2. :meth:`~..utils.chaos.ChaosPlan.shrink_topology` seed-kills ``kill``
   ranks;
3. :func:`~.replan.choose_plan` re-plans for the survivors (3 of 4, or 6
   of 8 — a non-power-of-2 mesh — exercising exactly the splits a
   power-of-2-only implementation gets wrong);
4. the plan's ranks restore the verified checkpoint onto the new layout
   with :func:`~.restore.restore_resharded`, and gather what they
   restored;
5. gates: the restored parameters AND optimizer state equal to the saved
   whole tensors (what a same-topology restore gives, bit for bit), and
   the elastic continuation (``--reshard --elastic --resume``: the CLI's
   ``fit_with_recovery`` + ``make_restore_fn`` — the real wiring, not a
   shortcut) reaches an epoch-2 loss close to the unshrunk topology's
   (``--resume`` on all ``n_devices`` ranks).

The global batch is 96, not the repo-default 64: every full-mesh plan
has batch-parallel degree == device count, and 64 does not divide over 6
survivors — 96 divides over 8, 6, 4 and 3, so the drill exercises a
*true* re-plan rather than silently stepping down.

``python -m distributed_deep_learning_tpu_torch.reshard.drill`` runs
the drill and prints its record; a spawned rank runs its step 4 through
the same module (``--restore``).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

_LOSS = re.compile(r'"train epoch (\d+) ends at \S+ with accuracy \S+ and '
                   r'loss (\S+)"')


def _epoch_loss(output: str, epoch: int) -> float:
    for m in _LOSS.finditer(output):
        if int(m.group(1)) == epoch:
            return float(m.group(2))
    raise LookupError(f"no train record for epoch {epoch}")


def _argv(ranks: int, batch: int, hidden: int, directory: str,
          epochs: int, *extra: str) -> list[str]:
    return ["mlp", "-m", "data", "--zero", "1", "-r", str(ranks), "-d",
            "cpu", "-b", str(batch), "-s", str(hidden), "-e", str(epochs),
            "--checkpoint-dir", directory, *extra]


def _restore_rank(argv: list[str], out: str, method: str) -> None:
    """A spawned rank of step 4: build the run's state for the re-planned
    layout as the CLI does, restore through the resharding path, gather
    the whole state and (rank 0) write it with the restore's info."""
    import torch

    from distributed_deep_learning_tpu_torch.reshard.replan import \
        resolve_restart_topology
    from distributed_deep_learning_tpu_torch.reshard.restore import \
        restore_resharded
    from distributed_deep_learning_tpu_torch.runtime import bootstrap
    from distributed_deep_learning_tpu_torch.tune.trial import \
        launched_devices
    from distributed_deep_learning_tpu_torch.utils.checkpoint import \
        state_payload
    from distributed_deep_learning_tpu_torch.utils.config import parse_args
    from distributed_deep_learning_tpu_torch.utils.logging import \
        PhaseLogger
    from distributed_deep_learning_tpu_torch.workloads import get_spec
    from distributed_deep_learning_tpu_torch.workloads.base import (
        build_dataset, train_setup)

    spec, config = get_spec("mlp"), parse_args(argv[1:], "mlp")
    env, _ = bootstrap.initialize("cpu")
    try:
        logger = PhaseLogger(verbose=False)
        dataset = build_dataset(spec, config)
        config = resolve_restart_topology(spec, config,
                                          launched_devices(config), logger,
                                          dataset=dataset)
        state, _, _, _, _, (ckpt, *_), _ = train_setup(
            spec, config, env, None, logger, dataset=dataset)
        start = time.perf_counter()
        restored, step, info = restore_resharded(
            ckpt, state, mesh=ckpt.mesh, method=method, logger=logger)
        seconds = time.perf_counter() - start
        payload = state_payload(restored, writer=env.rank == 0)
        if env.rank == 0:
            torch.save({"payload": payload, "step": step, "info": info,
                        "seconds": seconds}, out)
    finally:
        bootstrap.shutdown()


def _same(a, b) -> bool:
    """Two payload trees hold the same values, bit for bit."""
    import torch

    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.shape == b.shape and \
            bool(torch.equal(a, b.to(a.dtype)))
    if isinstance(a, dict):
        return isinstance(b, dict) and set(map(str, a)) == set(map(str, b)) \
            and all(_same(a[k], b[k] if k in b else b[str(k)]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_same, a, b))
    return a == b


def run_shrink_drill(seed: int = 0, kill: int = 2, *, n_devices: int = 8,
                     batch: int = 96, hidden: int = 512, rows: int = 1024,
                     method: str = "auto", timeout: float = 600.0) -> dict:
    """Run the full kill→re-plan→reshard→continue chain on gloo ranks;
    return the ``reshard`` drill record (all gates as booleans, wall
    times in seconds).  Deterministic under ``seed``."""
    import torch

    from distributed_deep_learning_tpu_torch.reshard.replan import (
        _pinned_options, choose_plan)
    from distributed_deep_learning_tpu_torch.runtime.launch import \
        launch_local
    from distributed_deep_learning_tpu_torch.tune.artifact import plan_hash
    from distributed_deep_learning_tpu_torch.utils.chaos import ChaosPlan
    from distributed_deep_learning_tpu_torch.utils.config import parse_args

    record: dict = {"metric": "shrink drill", "seed": seed,
                    "n_devices": n_devices, "batch": batch}
    env_keep = os.environ.get("DDL_DATA_LIMIT")
    os.environ["DDL_DATA_LIMIT"] = str(rows)
    try:
        with tempfile.TemporaryDirectory() as d:
            base = os.path.join(d, "ckpt")
            # --- all ranks: train epoch 1, checkpoint with its topology --
            launch_local(n_devices, _argv(n_devices, batch, hidden, base, 1),
                         device="cpu", timeout=timeout)

            # --- kill K of N (seeded, replayable) ------------------------
            survivors, dead = ChaosPlan.shrink_topology(
                list(range(n_devices)), kill=kill, seed=seed)
            record["killed"] = dead
            record["survivors"] = len(survivors)

            # --- re-plan for the survivors via tune/ ---------------------
            argv_b = _argv(len(survivors), batch, hidden, base, 2)
            plan = choose_plan(len(survivors), batch,
                               space_options=_pinned_options(
                                   parse_args(argv_b[1:], "mlp")))
            record["plan"] = plan.describe()
            record["plan_hash"] = plan_hash(plan)
            record["plan_devices"] = plan.n_devices
            record["non_power_of_two"] = any(
                s & (s - 1) for _, s in plan.mesh)

            # --- the plan's ranks restore onto their layout, while the
            # unshrunk and the resharded continuations run (each on its
            # own copy of the epoch-1 checkpoint)
            for leg in ("same", "restore", "resharded"):
                shutil.copytree(base, os.path.join(d, leg))
            out = os.path.join(d, "restored.pt")
            legs = {
                "restore": (plan.n_devices, [
                    "--restore", out, method, *_argv(
                        plan.n_devices, batch, hidden,
                        os.path.join(d, "restore"), 2, "--reshard",
                        "--resume")],
                    "distributed_deep_learning_tpu_torch.reshard.drill"),
                "same": (n_devices, _argv(
                    n_devices, batch, hidden, os.path.join(d, "same"), 2,
                    "--resume"), "distributed_deep_learning_tpu_torch"),
                # the real elastic wiring: fit_with_recovery restores
                # through the resharding restore_fn, then continues on
                # the new layout
                "resharded": (plan.n_devices, _argv(
                    plan.n_devices, batch, hidden,
                    os.path.join(d, "resharded"), 2, "--reshard",
                    "--elastic", "--resume"),
                    "distributed_deep_learning_tpu_torch")}
            with ThreadPoolExecutor(len(legs)) as pool:
                runs = {name: pool.submit(launch_local, n, argv,
                                          device="cpu", timeout=timeout,
                                          module=module)
                        for name, (n, argv, module) in legs.items()}
                runs = {name: run.result() for name, run in runs.items()}
            got = torch.load(out, weights_only=False)
            record["restore_seconds"] = round(got["seconds"], 4)
            record["restore_mode"] = got["info"].get("mode")
            record["restored_step"] = got["step"]

            # --- gate: equal to the saved whole tensors ------------------
            saved = torch.load(os.path.join(base, f"ckpt-{got['step']}.pt"),
                               weights_only=True)
            restored = got["payload"]
            record["params_allclose"] = _same(saved["params"],
                                              restored["params"])
            record["opt_state_allclose"] = _same(saved["optimizer"]["state"],
                                                 restored["optimizer"]
                                                 ["state"])

            # --- gate: continued loss matches the unshrunk topology ------
            loss_a = _epoch_loss(runs["same"][0].stdout, 2)
            loss_b = _epoch_loss(runs["resharded"][0].stdout, 2)
            record["loss_epoch2_same_topology"] = round(loss_a, 6)
            record["loss_epoch2_resharded"] = round(loss_b, 6)
            record["loss_allclose"] = bool(
                abs(loss_b - loss_a) <= 1e-5 + 5e-3 * abs(loss_a))
    finally:
        if env_keep is None:
            os.environ.pop("DDL_DATA_LIMIT", None)
        else:
            os.environ["DDL_DATA_LIMIT"] = env_keep

    record["drill_passed"] = bool(
        record["params_allclose"] and record["opt_state_allclose"]
        and record["loss_allclose"] and record["restored_step"] == 1
        and record["restore_mode"] in ("chunked", "gather"))
    return record


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "--restore":
        _restore_rank(argv[3:], argv[1], argv[2])
        return 0
    record = run_shrink_drill()
    print(json.dumps(record, sort_keys=True))
    return 0 if record["drill_passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
