"""Workload registry: the JAX package's workload names; this slice runs
``gpt``, and the others raise naming the ROADMAP item that ports them."""

from distributed_deep_learning_tpu_torch.utils.config import ROADMAP_ITEMS
from distributed_deep_learning_tpu_torch.workloads.base import (  # noqa: F401
    WorkloadSpec, run_workload)

WORKLOADS = ("mlp", "cnn", "lstm", "mnist", "resnet", "transformer",
             "bert", "moe", "gpt")


def get_spec(name: str) -> WorkloadSpec:
    name = name.lower()
    if name == "gpt":
        from distributed_deep_learning_tpu_torch.workloads.northstar import \
            GPT_SPEC
        return GPT_SPEC
    if name in WORKLOADS:
        raise NotImplementedError(f"workload {name!r} is not ported yet: "
                                  f"{ROADMAP_ITEMS[9]}")
    raise ValueError(f"unknown workload {name!r}; choose one of "
                     f"{'|'.join(WORKLOADS)}")
