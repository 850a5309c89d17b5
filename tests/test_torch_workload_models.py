"""The reference workloads' models (``mlp``, ``cnn``, ``lstm``, ``mnist``):
the port against the flax models on the same weights.

Each flax model is initialised from a seed and carried across with the
port's ``load_flax_variables``; inputs come from numpy with a seed.
Checked, per model: the forward in eval mode and in train mode (batch
statistics), in f32 (1e-5 of max|ref|, 1e-4 for DenseNet's conv stack)
and bf16 (2e-2 of max|ref|); one train step's gradients (1e-5 of the
model's max|g|; bf16 as its test says) and BatchNorm running statistics
against flax's updated ``batch_stats`` (1e-5; bf16 2e-2); ``torch.nn.BatchNorm2d``'s unbiased running
variance planted in their place must fail that check.  DenseNet runs
small, at ``-l 1`` (a 2×2 pooled map, where the flatten order matters)
and at its CLI default on a batch of 2 (the f32 forward).  ``--remat`` leaves the
gradients and the running statistics as they are without it.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_deep_learning_tpu.models import cnn_lstm as jlstm
from distributed_deep_learning_tpu.models import densenet as jdn
from distributed_deep_learning_tpu.models import mlp as jmlp
from distributed_deep_learning_tpu.models import resnet as jres
from distributed_deep_learning_tpu_torch.models import cnn_lstm as tlstm
from distributed_deep_learning_tpu_torch.models import densenet as tdn
from distributed_deep_learning_tpu_torch.models import mlp as tmlp
from distributed_deep_learning_tpu_torch.models import resnet as tres
from distributed_deep_learning_tpu_torch.train import objectives as tobj
from _torch_cpu import torch_threads  # noqa: F401  (autouse)

F32_TOL, CONV_TOL, BF16_TOL, STATS_TOL = 1e-5, 1e-4, 2e-2, 1e-5

#: name -> (flax model, port model, loader, input shape, loss)
CASES = {
    "mlp": (lambda dt: jmlp.MLP(hidden_size=16, num_hidden_layers=2,
                                dtype=dt),
            lambda dt: tmlp.MLP(48, hidden_size=16, num_hidden_layers=2,
                                dtype=dt),
            tmlp.load_flax_variables, (8, 48), "ce"),
    "mnist": (lambda dt: jres.MnistCNN(dtype=dt),
              lambda dt: tres.MnistCNN(dtype=dt),
              tres.load_flax_variables, (4, 28, 28, 1), "ce"),
    "lstm": (lambda dt: jlstm.CNNLSTM(hidden_layers=2, hidden_size=16,
                                      dtype=dt),
             lambda dt: tlstm.CNNLSTM(hidden_layers=2, hidden_size=16,
                                      dtype=dt),
             tlstm.load_flax_variables, (4, 10, 32), "l1"),
    "densenet_small": (
        lambda dt: jdn.DenseNet(dense_blocks=2, dense_layers=2,
                                growth_rate=8, bn_size=2, dtype=dt),
        lambda dt: tdn.DenseNet(dense_blocks=2, dense_layers=2,
                                growth_rate=8, bn_size=2, dtype=dt,
                                image_size=(32, 32)),
        tdn.load_flax_variables, (4, 32, 32, 3), "ce"),
    "densenet_l1": (
        lambda dt: jdn.DenseNet(dense_blocks=1, dense_layers=2,
                                growth_rate=8, bn_size=2, dtype=dt),
        lambda dt: tdn.DenseNet(dense_blocks=1, dense_layers=2,
                                growth_rate=8, bn_size=2, dtype=dt),
        tdn.load_flax_variables, (2, 64, 64, 3), "ce"),
    "densenet_default": (lambda dt: jdn.DenseNet(dtype=dt),
                         lambda dt: tdn.DenseNet(dtype=dt),
                         tdn.load_flax_variables, (2, 64, 64, 3), "ce"),
}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name, dtype):
    if dtype == "bf16":
        return BF16_TOL
    return CONV_TOL if name.startswith("densenet") else F32_TOL


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    if len(shape) == 3:                      # lstm: 5 regression targets
        y = rng.normal(size=(shape[0], 5)).astype(np.float32)
    else:
        n = 10 if shape[1:] == (28, 28, 1) else (6 if len(shape) == 4
                                                  else 5)
        y = np.eye(n, dtype=np.float32)[rng.integers(0, n, shape[0])]
    return x, y


@functools.lru_cache(maxsize=None)
def _variables(name):
    """The flax init (numpy) with non-trivial running statistics: one
    train-mode forward on another batch updates them."""
    jm = CASES[name][0](jnp.float32)
    shape = CASES[name][3]
    v = jax.jit(jm.init)(jax.random.key(7), jnp.zeros((1,) + shape[1:]))
    if "batch_stats" in v:
        x, _ = _inputs(shape, seed=9)
        _, upd = _apply(jm, True)(v, jnp.asarray(x) * 2 + 0.5)
        v = {"params": v["params"], "batch_stats": upd["batch_stats"]}
    return jax.tree.map(np.asarray, dict(v))


def _apply(jm, train):
    """The flax forward, jitted (one compile, not one per op); in train
    mode it returns the updated ``batch_stats`` too."""
    if train:
        return jax.jit(functools.partial(jm.apply, train=True,
                                         mutable=["batch_stats"]))
    return jax.jit(functools.partial(jm.apply, train=False))


def _port(name, dtype=torch.float32):
    tm = CASES[name][1](dtype)
    tm.load_state_dict(CASES[name][2](_variables(name)))
    return tm


def _jax_loss(kind):
    if kind == "l1":
        return lambda p, t: jnp.mean(jnp.abs(p - t))
    return lambda p, t: jnp.mean(optax.softmax_cross_entropy(p, t))


def _port_loss(kind):
    return tobj.l1_loss if kind == "l1" else tobj.cross_entropy_loss


def _close(got, want, tol, what):
    scale = float(np.max(np.abs(want))) or 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


#: DenseNet at its CLI default runs the f32 forward only (CPU time)
SMALL = [n for n in CASES if n != "densenet_default"]
FORWARD = [(n, d) for n in SMALL for d in DTYPES] + \
    [("densenet_default", "f32")]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name,dtype", FORWARD)
def test_forward_matches_flax(name, dtype, train):
    jdt, tdt = DTYPES[dtype]
    v = _variables(name)
    x, _ = _inputs(CASES[name][3])
    jm = CASES[name][0](jdt)
    if train and "batch_stats" in v:
        want, _ = _apply(jm, True)(v, jnp.asarray(x))
    else:
        want = _apply(jm, False)(v, jnp.asarray(x))
    tm = _port(name, tdt).train(train)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.dtype == torch.float32
    _close(got.numpy(), np.asarray(want, np.float32), _tol(name, dtype),
           f"{name} {dtype}")


def _flax_step(name, dtype="f32"):
    """flax's loss, gradients and updated batch_stats for one batch."""
    v = _variables(name)
    jm = CASES[name][0](DTYPES[dtype][0])
    x, y = (jnp.asarray(a) for a in _inputs(CASES[name][3]))
    rest = {k: val for k, val in v.items() if k != "params"}
    loss_fn = _jax_loss(CASES[name][4])

    def f(params):
        pred, upd = jm.apply({"params": params, **rest}, x, train=True,
                             mutable=list(rest))
        return loss_fn(pred, y), upd

    (loss, upd), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        v["params"])
    return (float(loss), jax.tree.map(np.asarray, grads),
            jax.tree.map(np.asarray, dict(upd)))


def _port_step(name, remat=None, dtype="f32"):
    tm = _port(name, DTYPES[dtype][1]).train()
    x, y = (torch.from_numpy(a) for a in _inputs(CASES[name][3]))
    loss = _port_loss(CASES[name][4])(tm(x, remat=remat), y)
    loss.backward()
    return tm, loss.item()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", SMALL)
def test_train_step_gradients_and_batch_stats_match_flax(name, dtype):
    """f32: the loss within 1e-5 (relative), each gradient within 1e-5 of
    the model's largest gradient entry (a BatchNorm parameter's gradient
    is a sum whose terms nearly cancel, so its rounding is the size of its
    neighbours' gradients), the running statistics within 1e-5.  bf16:
    the loss and statistics within 2e-2, and each gradient's relative L2
    distance from flax's f32 gradient at most twice flax's own bf16
    gradient's, plus 2e-2 (backpropagated through a stack of bf16
    BatchNorms at batch 4, flax's bf16 gradients themselves sit up to ~25%
    from its f32 ones, so a direct bf16-to-bf16 bound would measure
    rounding noise)."""
    tol = STATS_TOL if dtype == "f32" else BF16_TOL
    jloss, jgrads, upd = _flax_step(name, dtype)
    tm, loss = _port_step(name, dtype=dtype)
    np.testing.assert_allclose(loss, jloss, rtol=tol)
    v = _variables(name)
    load = CASES[name][2]
    want_grads = load({"params": jgrads, "batch_stats": v.get("batch_stats")})
    params = dict(tm.named_parameters())
    assert sorted(params) == sorted(k for k in want_grads
                                    if not k.endswith(("running_mean",
                                                       "running_var")))
    if dtype == "f32":
        scale = max(float(want_grads[k].abs().max()) for k in params)
        for k, p in params.items():
            np.testing.assert_allclose(p.grad.numpy(),
                                       want_grads[k].numpy(), rtol=0,
                                       atol=tol * scale, err_msg=k)
    else:
        f32 = load({"params": _flax_step(name)[1],
                    "batch_stats": v.get("batch_stats")})
        for k, p in params.items():
            norm = float(f32[k].norm()) or 1.0
            ours = float((p.grad - f32[k]).norm()) / norm
            theirs = float((want_grads[k] - f32[k]).norm()) / norm
            assert ours <= 2 * theirs + tol, (k, ours, theirs)
    if "batch_stats" in upd:
        want = load({"params": v["params"],
                     "batch_stats": upd["batch_stats"]})
        buffers = dict(tm.named_buffers())
        assert buffers and sorted(buffers) == sorted(
            k for k in want if k.endswith(("running_mean", "running_var")))
        for k, b in buffers.items():
            np.testing.assert_allclose(b.numpy(), want[k].numpy(), rtol=0,
                                       atol=tol, err_msg=k)


def test_torch_batchnorm_unbiased_variance_fails_the_check():
    """Planted control: the stem's BatchNorm as ``torch.nn.BatchNorm2d``
    (momentum 0.99, eps 1e-3) keeps the unbiased batch variance, which
    misses flax's running variance by more than the check allows; the
    port's BatchNorm is within it."""
    name = "densenet_small"
    _, _, upd = _flax_step(name)
    want = upd["batch_stats"]["StemNorm_0"]["BatchNorm_0"]["var"]
    tm = _port(name).train()
    x, _ = _inputs(CASES[name][3])
    with torch.no_grad():
        stem = tm.layers[0](torch.from_numpy(x).permute(0, 3, 1, 2))
        port_bn = tm.layers[1].norm
        planted = torch.nn.BatchNorm2d(stem.shape[1], eps=1e-3,
                                       momentum=0.99)
        planted.running_var.copy_(port_bn.running_var)
        planted.running_mean.copy_(port_bn.running_mean)
        planted.train()(stem)
        port_bn(stem)
    ours = np.abs(port_bn.running_var.numpy() - want).max()
    theirs = np.abs(planted.running_var.numpy() - want).max()
    assert ours <= STATS_TOL < theirs, (ours, theirs)


@pytest.mark.parametrize("name", ["densenet_small", "lstm"])
def test_remat_leaves_gradients_and_running_stats_unchanged(name):
    """``--remat`` recomputes each layer in the backward without updating
    the BatchNorm statistics a second time."""
    plain, loss = _port_step(name)
    remat, loss_r = _port_step(name, remat="nothing")
    assert loss_r == loss
    for (k, a), (_, b) in zip(plain.named_parameters(),
                              remat.named_parameters()):
        torch.testing.assert_close(b.grad, a.grad, rtol=0, atol=0,
                                   msg=k)
    for (k, a), (_, b) in zip(plain.named_buffers(), remat.named_buffers()):
        torch.testing.assert_close(b, a, rtol=0, atol=0, msg=k)


def test_remat_policies_other_than_nothing_are_refused():
    """The policies other than ``nothing`` were refused on these models
    until they had JAX's selective policies; now ``dots`` and
    ``dots_no_batch`` leave DenseNet's gradients and running statistics
    as they are without remat, and a name JAX does not have is refused."""
    plain, loss = _port_step("densenet_small")
    for policy in ("dots", "dots_no_batch"):
        remat, loss_r = _port_step("densenet_small", remat=policy)
        assert loss_r == loss
        want = [p.grad for p in plain.parameters()] + list(plain.buffers())
        got = [p.grad for p in remat.parameters()] + list(remat.buffers())
        for a, b in zip(want, got):
            torch.testing.assert_close(b, a, rtol=0, atol=0)
    tm = _port("densenet_small").train()
    x, _ = _inputs(CASES["densenet_small"][3])
    with pytest.raises(ValueError, match="unknown remat policy"):
        tm(torch.from_numpy(x), remat="everything")


def test_port_parameters_are_flax_shaped_and_initialised():
    """``reset_parameters`` draws flax's initialisers: zero biases, unit
    BN scales, unit running variances, per-gate orthogonal LSTM hidden
    kernels, and kernels whose spread is ``sqrt(scale / fan_in)``."""
    gen = torch.Generator().manual_seed(0)
    dn = tdn.DenseNet().reset_parameters(gen)
    stem = dn.layers[0].conv.weight
    np.testing.assert_allclose(float(stem.detach().std()), (2 / (7 * 7 * 3)) ** 0.5,
                               rtol=0.05)
    bn = dn.layers[1].norm
    assert bool((bn.weight == 1).all() and (bn.bias == 0).all()
                and (bn.running_var == 1).all()
                and (bn.running_mean == 0).all())
    lstm = tlstm.CNNLSTM(hidden_size=32).reset_parameters(gen)
    layer = lstm.layers[2]
    assert bool((layer.bias == 0).all())
    for j in range(4):
        w = layer.weight_hh[j * 32:(j + 1) * 32]
        torch.testing.assert_close(w @ w.T, torch.eye(32), atol=1e-5,
                                   rtol=0)
    counts = {n: p.numel() for n, p in lstm.named_parameters()}
    jcounts = jax.tree.map(lambda a: a.size, jlstm.CNNLSTM(
        hidden_size=32).init(jax.random.key(0), jnp.zeros((1, 10, 32))))
    assert sum(counts.values()) == sum(jax.tree.leaves(jcounts))
