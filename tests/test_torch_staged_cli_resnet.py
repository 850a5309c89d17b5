"""ResNet-18 (the CIFAR twin's 3×3 stem) through the port's CLI under
``-m model --nstages 2`` against the JAX CLI from JAX's initial per-stage
weights, as ``test_torch_staged_cli`` holds the reference's workloads
(1e-3 relative: a BatchNorm net's f32 rounding grows over its steps)."""

from test_torch_staged_cli import (_two_threads, check_history,  # noqa: F401
                                   staged_init)
from _torch_cpu import torch_threads  # noqa: F401  (autouse)


def test_resnet_model_cli_history_matches_jax(monkeypatch):
    check_history("resnet", 96, ["-m", "model", "--nstages", "2", "-s", "18",
                                 "-e", "1", "-b", "8"], monkeypatch,
                  staged_init, 1e-3)
