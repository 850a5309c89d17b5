"""The pipelined LM against the JAX package's, as
``test_torch_pipelined_lm`` holds it: one train step's loss and gradients
for ``gpt`` with rotary positions, a window of 5 and 2 KV heads, and for
``transformer`` (the head reads ``take``), under each schedule;
then AdamW, LAMB and Adafactor each take one step on the interleaved
``(V, S, ...)`` stack from the same parameters and gradients."""

import jax
import numpy as np
import optax
import pytest

from distributed_deep_learning_tpu.workloads import base as jbase
from distributed_deep_learning_tpu_torch.models.transformer import \
    load_flax_params
from distributed_deep_learning_tpu_torch.train.state import (Optimizer,
                                                             TrainState)
from distributed_deep_learning_tpu_torch.workloads import base as tbase
from test_torch_pipelined_lm import (  # noqa: F401
    LR, _data, _jax_model, _port_model, _two_threads, check_step)
from _torch_cpu import torch_threads  # noqa: F401  (autouse)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b", "interleaved"])
@pytest.mark.parametrize("case", ["gpt_rope_window_gqa", "transformer"])
def test_train_step_variants_match_jax(case, schedule):
    check_step(case, schedule)


OPTIMIZERS = {
    "adamw": (lambda: jbase.adamw(LR), lambda: tbase.adamw(LR)),
    "lamb": (lambda: optax.lamb(LR, weight_decay=1e-2,
                                mask=jbase._decay_mask),
             lambda: Optimizer("lamb", LR, weight_decay=1e-2,
                               decay_mask=tbase.decay_mask)),
    "adafactor": (lambda: optax.adafactor(learning_rate=LR),
                  lambda: Optimizer("adafactor", LR)),
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_step_on_the_stacked_layout(name):
    """One optimizer step on the interleaved ``(V, S, ...)`` stack, JAX's
    and the port's, from the same parameters and gradients (seeded, one
    leaf scaled to zero: LAMB's trust ratio of a zero update is 1)."""
    _, jmodel = _jax_model("gpt", 2)
    tokens, _ = _data("gpt")
    params = jmodel.init(jax.random.key(3), tokens[:1])
    rng = np.random.default_rng(2)
    grads = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(a.dtype) * 1e-2,
        params)
    grads["head"]["Dense_0"]["bias"] = grads["head"]["Dense_0"]["bias"] * 0
    jtx, ttx = (make() for make in OPTIMIZERS[name])
    updates, _ = jtx.update(grads, jtx.init(params), params)
    want = load_flax_params(jax.tree.map(
        np.asarray, optax.apply_updates(params, updates)))
    model = _port_model("gpt", 2)
    model.load_state_dict(load_flax_params(jax.tree.map(np.asarray,
                                                        params)))
    g = load_flax_params(jax.tree.map(np.asarray, grads))
    for k, p in model.named_parameters():
        p.grad = g[k].clone()
    state = TrainState(model=model, tx=ttx, optimizer=ttx.build(
        model.named_parameters(), layout=model.flax_layout))
    state.apply_gradients()
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(
            v.numpy(), want[k].numpy(), rtol=0,
            atol=1e-4 * float(want[k].abs().max()), err_msg=k)
