"""Workload registry: the JAX package's workload names.  The port runs
every one of them."""

from distributed_deep_learning_tpu_torch.workloads.base import (  # noqa: F401
    WorkloadSpec, run_workload)

WORKLOADS = ("mlp", "cnn", "lstm", "mnist", "resnet", "transformer",
             "bert", "moe", "gpt")


def get_spec(name: str) -> WorkloadSpec:
    """Late-import specs so `import workloads` stays cheap."""
    name = name.lower()
    if name == "mlp":
        from distributed_deep_learning_tpu_torch.workloads.mlp import SPEC
    elif name == "cnn":
        from distributed_deep_learning_tpu_torch.workloads.cnn import SPEC
    elif name == "lstm":
        from distributed_deep_learning_tpu_torch.workloads.lstm import SPEC
    elif name == "mnist":
        from distributed_deep_learning_tpu_torch.workloads.mnist import SPEC
    elif name in ("resnet", "transformer", "bert", "moe", "gpt"):
        from distributed_deep_learning_tpu_torch.workloads.northstar import \
            SPECS
        SPEC = SPECS[name]
    else:
        raise ValueError(f"unknown workload {name!r}; choose one of "
                         f"{'|'.join(WORKLOADS)}")
    return SPEC
