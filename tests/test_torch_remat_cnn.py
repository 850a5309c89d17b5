"""``--remat --remat-policy dots|dots_no_batch`` on ``cnn``: the
port's phase losses equal the JAX CLI's under the same policy within
1e-5 and the port's run without remat bit for bit, BatchNorm running
statistics included (``test_torch_remat_conv.check``, in a file of its
own: JAX's compiles of this model under remat take most of its time).
"""

import pytest

from _torch_cpu import torch_threads  # noqa: F401  (autouse)
from test_torch_remat_conv import POLICIES, check


@pytest.mark.parametrize("policy", POLICIES)
def test_cnn_remat_policy_matches_jax_and_the_run_without_remat(policy):
    check("cnn", policy)
