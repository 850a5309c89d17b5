"""Package entry point: ``python -m distributed_deep_learning_tpu_torch
<workload> [flags]``, the JAX package's CLI (``-l -s -e -b -d -w -m -p
-r`` and its extensions); this slice trains ``gpt -m sequential``."""

from __future__ import annotations

import sys


def main(argv: list[str] | None = None):
    """Run one workload; returns ``(state, history)`` (None for help)."""
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
    spec = get_spec(name)
    return run_workload(spec, parse_args(rest, workload=name))


if __name__ == "__main__":
    main()
