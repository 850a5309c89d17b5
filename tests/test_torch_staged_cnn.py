"""Staged DenseNet-BC at one dense block (``cnn -l 1``: its BatchNorms
staged over two stages, ``-m model`` and ``-m pipeline -p 3``) against the
JAX package's ``StagedTrainer``, as ``test_torch_staged`` holds the other
reference workloads."""

import pytest

from test_torch_staged import MODES, _two_threads, check_step  # noqa: F401
from _torch_cpu import torch_threads  # noqa: F401  (autouse)


@pytest.mark.parametrize("mode", list(MODES))
def test_staged_cnn_step_matches_jax(mode):
    check_step("cnn", ["-l", "1"] + MODES[mode])
