"""Package entry point: ``python -m distributed_deep_learning_tpu_torch
<workload> [flags]``, the JAX package's CLI (``-l -s -e -b -d -w -m -p
-r`` and its extensions); the port trains every workload of it under
``-m sequential|data``.
``--spawn -r N`` runs N local ranks (:mod:`.runtime.launch`) and prints
their output in rank order."""

from __future__ import annotations

import sys


def main(argv: list[str] | None = None):
    """Run one workload; returns ``(state, history)`` (None for help and
    for ``--spawn``)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    from distributed_deep_learning_tpu_torch.workloads import (WORKLOADS,
                                                               get_spec,
                                                               run_workload)
    from distributed_deep_learning_tpu_torch.utils.config import parse_args

    if not argv or argv[0] in ("-h", "--help"):
        print(f"usage: python -m distributed_deep_learning_tpu_torch "
              f"{{{'|'.join(WORKLOADS)}}} [flags]\n"
              f"Run '<workload> -h' for the per-workload flag reference.")
        return None
    name, rest = argv[0], argv[1:]
    if "--spawn" in rest:
        from distributed_deep_learning_tpu_torch.runtime.launch import \
            launch_local

        rest = [a for a in rest if a != "--spawn"]
        config = parse_args(rest, workload=name)
        if config.world_size < 2:
            raise SystemExit("--spawn needs -r N with N >= 2")
        for res in launch_local(config.world_size, [name, *rest],
                                device=config.device):
            sys.stdout.write(res.stdout)
        return None
    spec = get_spec(name)
    return run_workload(spec, parse_args(rest, workload=name))


if __name__ == "__main__":
    main()
