"""Staged ResNet-18 (CIFAR stem, ``-m model`` and ``-m pipeline -p 3``)
against the JAX package's ``StagedTrainer``, as ``test_torch_staged``
holds the reference's workloads: one SGD step from JAX's weights plus
seeded noise, then the loss, every parameter and the BatchNorm
statistics."""

import pytest

from test_torch_staged import MODES, _two_threads, check_step  # noqa: F401
from _torch_cpu import torch_threads  # noqa: F401  (autouse)


@pytest.mark.parametrize("mode", list(MODES))
def test_staged_resnet_step_matches_jax(mode):
    check_step("resnet", ["-s", "18"] + MODES[mode])
