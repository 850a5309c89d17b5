"""Tensor (Megatron-style) and expert parallelism: the port of
``distributed_deep_learning_tpu/parallel/tensor_parallel.py``.

The JAX package states tensor parallelism as ``PartitionSpec`` rules on
parameter paths and lets XLA insert the collectives.  Here the same rules
(:func:`transformer_tp_rules`, and ``models.moe.moe_param_rules`` for the
experts), written against the port's parameter names, split the
parameters themselves: :func:`apply_tensor_parallel` keeps on each rank
its even slice of each ruled parameter as a plain tensor (tagged with a
``parallel.shards.TensorShard``) and turns the modules that hold them
into their parallel forms, whose forwards carry the collectives:

* q/k/v column-parallel (rows of ``(H·hd, d)``: this rank's heads; the
  attention then runs on ``H/K`` local heads, through the flash kernels
  where the model uses them), ``out`` row-parallel (columns; the ranks
  sum their partial products, then the bias is added once);
* ``mlp_in`` column-parallel, ``mlp_out`` row-parallel;
* the tied ``tok`` table split over its vocabulary: a masked lookup
  summed over the group, and a head that gathers every rank's logits
  (or a vocab-parallel fused cross-entropy, ``ops.fused_ce``);
* the MoE expert kernels split on their leading ``E`` axis.

Every rank of a group computes the replicated activations in between
identically, so the replicated parameters' gradients agree without a
collective, and a mesh's batch axes average the gradients as in ``-m
data``.  The optimizer moments of a split parameter are split with it
(the JAX package's ``tp_state_spec``).
"""

from __future__ import annotations

import re
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from distributed_deep_learning_tpu_torch.models.transformer import (
    Dense, MultiHeadAttention, recomputable)
from distributed_deep_learning_tpu_torch.parallel.shards import (
    TensorShard, copy_to, reduce_from)

#: ``(name regex, dim, mesh axis)``: the first rule a parameter's name
#: matches splits that dim of its torch tensor over that axis
Rules = Sequence[tuple[str, int, str]]


def transformer_tp_rules(axis: str = "model") -> Rules:
    """Megatron sharding of ``models.transformer``'s parameters (the JAX
    package's ``transformer_tp_rules`` against the port's names: q/k/v
    ``(H·hd, d)`` and their biases on the heads axis, ``out`` ``(d,
    H·hd)`` on its input axis, ``mlp_in`` (JAX's ``Dense_0``) on its
    output axis, ``mlp_out`` (``Dense_1``) on its input axis, the tied
    ``tok`` table ``(V, d)`` on the vocabulary)."""
    return (
        (r"(^|.*\.)(self_attn|cross_attn)\.(q|k|v)\.(weight|bias)$", 0,
         axis),
        (r"(^|.*\.)(self_attn|cross_attn)\.out\.weight$", 1, axis),
        (r"(^|.*\.)mlp_in\.(weight|bias)$", 0, axis),
        (r"(^|.*\.)mlp_out\.weight$", 1, axis),
        (r"(^|.*\.)tok\.weight$", 0, axis),
    )


def param_specs(model: nn.Module, rules: Rules) -> dict:
    """``{name: (dim, axis)}`` of ``model``'s parameters that a rule
    splits (unmatched ones stay replicated)."""
    specs = {}
    for name, _ in model.named_parameters():
        for pattern, dim, axis in rules:
            if re.match(pattern, name):
                specs[name] = (dim, axis)
                break
    return specs


# --- the JAX package's parameter paths: its checks' order and messages ------

def _flax_leaf(module: nn.Module, leaf: str) -> str:
    if isinstance(module, nn.LayerNorm):
        return {"weight": "scale"}.get(leaf, leaf)
    if isinstance(module, nn.Embedding):
        return "embedding"
    if isinstance(module, nn.Linear):
        return {"weight": "kernel"}.get(leaf, leaf)
    return leaf


def flax_path(model: nn.Module, name: str) -> str:
    """The flax parameter path of the port's parameter ``name`` (the
    inverse of ``models.transformer.load_flax_params``'s table)."""
    from distributed_deep_learning_tpu_torch.models.moe import \
        MoETransformerLayer

    *mods, leaf = name.split(".")
    out, m, i, layer = [], model, 0, None
    while i < len(mods):
        c = mods[i]
        child = getattr(m, c)
        if isinstance(child, nn.ModuleList):
            layer = child[int(mods[i + 1])]
            base = {"layers": "layer"}.get(c, c)
            if isinstance(layer, MoETransformerLayer):
                base = "moe_layer"
            out.append(f"{base}_{mods[i + 1]}")
            m, i = layer, i + 2
            continue
        if c == "tok":
            out += ["embed", "tok"]
        elif c in ("mlp_in", "mlp_out"):
            out.append("Dense_0" if c == "mlp_in" else "Dense_1")
        elif c == "ln_attn":
            out.append("LayerNorm_0")
        elif c == "ln_cross":
            out.append("LayerNorm_1")
        elif c == "ln_mlp":
            cross = getattr(layer, "cross_attention", False)
            out.append(f"LayerNorm_{2 if cross else 1}")
        else:
            out.append(c)
        m, i = child, i + 1
    if leaf == "pos":                  # the model's own, beside tok
        return "/".join(out + ["embed", "pos"])
    return "/".join(out + [_flax_leaf(m, leaf)])


def _flax_view(model: nn.Module, name: str, p: torch.Tensor, dim: int):
    """``(flax shape, flax dim)`` of ``p`` and its torch ``dim``: the flax
    axis that grows when ``dim`` does (a head count, not ``head_dim``)."""
    to_flax = model.flax_layout(name)[0] if hasattr(model, "flax_layout") \
        else (lambda t: t)
    shape = tuple(to_flax(torch.empty(p.shape, device="meta")).shape)
    grown = list(p.shape)
    grown[dim] *= 7
    bigger = tuple(to_flax(torch.empty(grown, device="meta")).shape)
    return shape, next(d for d in range(len(shape))
                       if bigger[d] != shape[d])


def validate_divisibility(model: nn.Module, sizes: dict, rules: Rules
                          ) -> None:
    """Fail fast, in the JAX package's words and leaf order, when a
    rule's mesh axis does not divide the parameter dim it splits."""
    specs = param_specs(model, rules)
    params = dict(model.named_parameters())
    for name in sorted(specs, key=lambda n: flax_path(model, n)):
        dim, axis = specs[name]
        size = sizes.get(axis, 1)
        shape, fdim = _flax_view(model, name, params[name], dim)
        if shape[fdim] % size:
            raise ValueError(f"dim {fdim} of shape {shape} not divisible "
                             f"by mesh axis {axis}={size}")


# --- the parallel modules -----------------------------------------------------

class ColumnParallelDense(Dense):
    """A ``Dense`` holding this rank's output rows (and their bias);
    ``group``, when set, sums the ranks' input gradients (None when the
    owner does that once for several projections, as
    ``MultiHeadAttention.project`` does)."""

    group = None

    def forward(self, x):
        x = copy_to(x, self.group)
        return F.linear(x, recomputable(self.weight.to, x.dtype),
                        self.bias.to(x.dtype))


class RowParallelDense(Dense):
    """A ``Dense`` holding this rank's input columns: the ranks' partial
    products are summed over ``group``, then the (whole) bias added."""

    group = None

    def forward(self, x):
        y = F.linear(x, recomputable(self.weight.to, x.dtype))
        return reduce_from(y, self.group) + self.bias.to(x.dtype)


class VocabParallelEmbedding(nn.Embedding):
    """An embedding table holding rows ``[vocab_start, vocab_start + n)``
    of the whole vocabulary: a token outside them looks up zeros, and the
    ranks of ``group`` sum their rows (exactly one is not zero).
    ``models.transformer.tied_logits`` and ``CausalLM.loss`` read
    ``group`` and ``vocab_start`` for the tied head."""

    group, vocab_start = None, 0

    def forward(self, tokens):
        n = self.weight.shape[0]
        local = tokens - self.vocab_start
        inside = (local >= 0) & (local < n)
        rows = F.embedding(local.clamp(0, n - 1), self.weight)
        rows = rows * inside[..., None].to(rows.dtype)
        return reduce_from(rows, self.group)


def _split(p: nn.Parameter, dim: int, index: int, parts: int, group,
           axis: str) -> nn.Parameter:
    n = p.shape[dim] // parts
    out = nn.Parameter(p.detach().narrow(dim, index * n, n).clone(),
                       requires_grad=p.requires_grad)
    out.tp_shard = TensorShard(dim, index, parts, group, axis)
    return out


def apply_tensor_parallel(model: nn.Module, rules: Rules, layout
                          ) -> nn.Module:
    """Split ``model``'s ruled parameters over ``layout``'s (a
    ``runtime.mesh.MeshLayout``) ``model`` and ``expert`` groups, in
    place: each rank keeps its slice, and the modules holding them take
    their parallel forms.  Raises (JAX's message) on an indivisible dim
    before anything changes."""
    from distributed_deep_learning_tpu_torch.models.moe import MoEMLP

    validate_divisibility(model, layout.sizes, rules)
    groups = {"model": layout.model_group, "expert": layout.expert_group}
    specs = {name: spec for name, spec in param_specs(model, rules).items()
             if layout.sizes.get(spec[1], 1) > 1}
    for mod_name, mod in list(model.named_modules()):
        prefix = f"{mod_name}." if mod_name else ""
        split = {leaf: specs[prefix + leaf]
                 for leaf, _ in mod.named_parameters(recurse=False)
                 if prefix + leaf in specs}
        if not split:
            continue
        for leaf, (dim, axis) in split.items():
            setattr(mod, leaf, _split(getattr(mod, leaf), dim,
                                      layout.coord[axis],
                                      layout.sizes[axis], groups[axis],
                                      axis))
        dim, axis = next(iter(split.values()))
        group, index = groups[axis], layout.coord[axis]
        if isinstance(mod, MoEMLP):
            mod.expert_group = group
            mod.expert_start = index * mod.w_in.shape[0]
        elif isinstance(mod, nn.Embedding):
            mod.__class__ = VocabParallelEmbedding
            mod.group, mod.vocab_start = group, index * mod.weight.shape[0]
        elif isinstance(mod, Dense):
            mod.__class__ = ColumnParallelDense if dim == 0 \
                else RowParallelDense
            mod.group = group
        else:
            raise ValueError(f"no parallel form for {type(mod).__name__} "
                             f"{mod_name!r}")
    for mod in model.modules():
        if isinstance(mod, MultiHeadAttention) and \
                isinstance(mod.q, ColumnParallelDense):
            # one input all-reduce for q, k and v together
            mod.tp_group = mod.q.group
            for proj in (mod.q, mod.k, mod.v):
                proj.group = None
            mod.num_heads = mod.q.weight.shape[0] // mod.head_dim
            mod.kv_heads = mod.k.weight.shape[0] // mod.head_dim
    return model
