"""DenseNet-BC at one dense block through the port's CLI under ``-m
pipeline --nstages 2 -p 4`` against the JAX CLI from JAX's initial
per-stage weights, as ``test_torch_staged_cli`` holds the other reference
workloads (1e-3 relative: a BatchNorm net's f32 rounding grows over its
steps)."""

from test_torch_staged_cli import (_two_threads, check_history,  # noqa: F401
                                   staged_init)
from _torch_cpu import torch_threads  # noqa: F401  (autouse)


def test_cnn_pipeline_cli_history_matches_jax(monkeypatch):
    check_history("cnn", 96, ["-m", "pipeline", "--nstages", "2", "-p", "4",
                              "-l", "1", "-s", "2", "-e", "1", "-b", "8"],
                  monkeypatch, staged_init, 1e-3)
