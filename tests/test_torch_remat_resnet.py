"""``--remat --remat-policy dots|dots_no_batch`` on ``resnet``: the
port's phase losses equal the JAX CLI's under the same policy within
1e-5 and the port's run without remat bit for bit, BatchNorm running
statistics included (``test_torch_remat_conv.check``, in a file of its
own: JAX's compiles of this model under remat take most of its time).
"""

import pytest

from _torch_cpu import torch_threads  # noqa: F401  (autouse)
from test_torch_remat_conv import POLICIES, check


@pytest.mark.parametrize("policy", POLICIES)
def test_resnet_remat_policy_matches_jax_and_the_run_without_remat(policy):
    check("resnet", policy)


def test_dots_keeps_the_convolutions_and_dots_no_batch_drops_them(
        monkeypatch):
    """What a ResNet block's forward leaves saved for its backward: under
    ``dots`` the saved-tensor hooks drop the BatchNorm, ReLU and padding
    outputs and keep the convolutions'; under ``dots_no_batch`` they drop
    the convolutions' too; the recomputed gradients equal the run
    without remat bit for bit."""
    import torch

    from distributed_deep_learning_tpu_torch.models import layers
    from distributed_deep_learning_tpu_torch.models.resnet import (
        BasicBlock, ResNet)

    kept = []
    finish = layers._Recompute.finish

    def counting_finish(self):
        marked = {layers._storage_key(out) for out, _, _ in self.marked}
        saved = {layers._storage_key(h[0]): h[0].untyped_storage().nbytes()
                 for h in self.saved}
        kept.append((sum(saved.values()),
                     sum(b for k, b in saved.items() if k not in marked)))
        return finish(self)

    monkeypatch.setattr(layers._Recompute, "finish", counting_finish)
    x = torch.randn(4, 16, 16, 3, generator=torch.Generator().manual_seed(0))
    grads, saved = {}, {}
    for policy in (None, "dots", "dots_no_batch"):
        model = ResNet(stage_sizes=(1, 1), block_cls=BasicBlock,
                       num_classes=5, width=8, small_inputs=True)
        model.reset_parameters(torch.Generator().manual_seed(0))
        kept.clear()
        model(x, remat=policy).sum().backward()
        saved[policy] = (sum(a for a, _ in kept), sum(k for _, k in kept))
        grads[policy] = {n: p.grad for n, p in model.named_parameters()}
    total, dots = saved["dots"]
    assert saved["dots_no_batch"][0] == total
    assert 0 < saved["dots_no_batch"][1] < dots < total
    for policy in ("dots", "dots_no_batch"):
        for name, g in grads[None].items():
            assert torch.equal(grads[policy][name], g), (policy, name)
