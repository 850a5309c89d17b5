"""The sparse-expert MLM: the port of
``distributed_deep_learning_tpu/models/moe.py`` — GShard top-2 gating
(:func:`top2_gating`), the routed MLP (:class:`MoEMLP`), the pre-LN block
that carries it (:class:`MoETransformerLayer`) and the ``moe`` workload's
model (:class:`MoELM`).

Dispatch is the dense one-hot formulation of the flax model: ``(G, E,
C)`` dispatch and combine tensors contracted with the token stream in
plain products (the JAX package computes them outside any Pallas kernel).
The load-balance loss is sown (:func:`..layers.sow_loss`); the train step
adds what its forward sowed to the objective, never to the logged loss.

Under ``-m data`` the JAX package routes the global batch in one program.
:func:`global_routing` makes each rank route its rows as that program
does: the capacity comes from the global token count, a rank's queue
positions start after the lower ranks' tokens (their per-expert counts
from an all-gather), the second choices queue behind every rank's first
choices, and the load-balance means are global (a differentiable
all-reduce of the summed router probabilities).  The collectives run on
their own process group, so they cannot interleave with DDP's gradient
all-reduces, which run on the default group during the backward while a
``--remat`` recompute routes again.

Under ``--mesh expert=K`` (:func:`moe_param_rules`) each rank of an
expert group holds ``E/K`` experts' kernels and sees the same tokens
(the batch is split over the batch axes only): it routes every token as
the others do, runs its own experts' slots, and the ranks sum their
partial outputs (a differentiable all-reduce over the expert group).
The routing itself stays on the batch axes' group.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from distributed_deep_learning_tpu_torch.models.layers import sow_loss
from distributed_deep_learning_tpu_torch.models.transformer import (
    Dense, LayerNorm, TransformerLayer, _EncoderModel, _gelu, recomputable)
from distributed_deep_learning_tpu_torch.parallel.shards import (
    copy_to, reduce_from)


def _routing_totals(counts: torch.Tensor, group) -> tuple:
    """``(below, total)`` of this rank's per-expert ``counts``: the sums
    over the lower ranks of ``group`` and over every rank (``below`` 0
    and ``total`` the counts themselves without a group)."""
    if group is None:
        return torch.zeros_like(counts), counts
    gathered = [torch.empty_like(counts)
                for _ in range(dist.get_world_size(group))]
    dist.all_gather(gathered, counts, group=group)
    rank = dist.get_rank(group)
    stacked = torch.stack(gathered)
    return stacked[:rank].sum(0), stacked.sum(0)


def _global_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``'s ranks, differentiably (the backward
    sums the ranks' gradients); ``x`` itself without a group."""
    if group is None:
        return x
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(x, group=group)


def _slots(pos: torch.Tensor, capacity: int) -> torch.Tensor:
    """The one-hot ``(G, C)`` capacity slot of each token's position.
    ``jax.nn.one_hot`` gives a zero row at ``pos >= C`` where torch's
    raises; such a token is dropped (its ``keep`` row is zero), so the
    clamped row it gets here is multiplied away as JAX's zero row is."""
    idx = pos.sum(-1).long().clamp_(max=capacity - 1)
    return F.one_hot(idx, capacity).to(pos.dtype)


def top2_gating(logits: torch.Tensor, capacity: int, group=None):
    """GShard top-2 gating with capacity-limited dispatch.

    ``logits`` ``(G, E)`` are router logits of this rank's G tokens;
    ``capacity`` is the slot count C of an expert.  Returns ``(dispatch,
    combine, aux)``: ``(G, E, C)`` 0/1 dispatch and combine weights, and
    the load-balance loss ``E · Σ_e mean(mask1)_e · mean(probs)_e``.  The
    first choice is the argmax of the probabilities, the second the
    argmax with the first masked out (the first maximum wins a tie).  A
    token's slot is its position in its expert's queue: first choices
    queue in token order, second choices after every first choice of that
    expert (dropped ones included); a position at or past C is dropped.
    The two kept gates are renormalised by ``max(g1 + g2, 1e-9)``.

    With ``group`` (see :func:`global_routing`) the G tokens are this
    rank's share of the global batch, in rank order: positions, the
    second choices' base and the means are taken over every rank's
    tokens, as the JAX package's one program takes them."""
    G, E = logits.shape
    probs = torch.softmax(logits, dim=-1)
    mask1 = F.one_hot(probs.argmax(-1), E).to(probs.dtype)
    mask2 = F.one_hot((probs * (1.0 - mask1)).argmax(-1), E).to(probs.dtype)
    below, total = _routing_totals(torch.stack([mask1.sum(0), mask2.sum(0)]),
                                   group)
    n = G if group is None else G * dist.get_world_size(group)

    density = total[0] / n                            # fraction routed
    density_proxy = _global_sum(probs.sum(0), group) / n
    aux = torch.sum(density * density_proxy) * (E ** 2) / E

    pos1 = (torch.cumsum(mask1, 0) - mask1 + below[0]) * mask1
    pos2 = (torch.cumsum(mask2, 0) - mask2 + below[1] + total[0]) * mask2
    keep1 = mask1 * (pos1 < capacity)
    keep2 = mask2 * (pos2 < capacity)

    g1 = torch.sum(probs * keep1, dim=-1)
    g2 = torch.sum(probs * keep2, dim=-1)
    denom = torch.clamp(g1 + g2, min=1e-9)
    g1, g2 = g1 / denom, g2 / denom

    slot1, slot2 = _slots(pos1, capacity), _slots(pos2, capacity)
    dispatch = (keep1[..., None] * slot1[:, None, :]
                + keep2[..., None] * slot2[:, None, :])
    combine = (g1[:, None, None] * keep1[..., None] * slot1[:, None, :]
               + g2[:, None, None] * keep2[..., None] * slot2[:, None, :])
    return dispatch, combine, aux


def _xavier_uniform_(w: torch.Tensor, generator=None):
    """flax's ``xavier_uniform`` on a stacked ``(E, in, out)`` kernel:
    fans ``E·in`` and ``E·out``."""
    E, fan_in, fan_out = w.shape
    a = float(np.sqrt(6.0 / (E * fan_in + E * fan_out)))
    with torch.no_grad():
        return w.uniform_(-a, a, generator=generator)


class MoEMLP(nn.Module):
    """Top-2 routed MLP: ``x → router → dispatch → expert FFN → combine``.

    The router is an f32 ``Dense(E)`` on f32 tokens; the expert kernels
    ``w_in`` ``(E, d, m)`` and ``w_out`` ``(E, m, d)`` are f32 parameters
    cast to ``dtype`` at use, and the dispatch, expert and combine
    products run in ``dtype``.  The output is f32 (the flax module casts
    it), so under bf16 the residual stream it is added to becomes f32.
    The load-balance loss, times ``aux_loss_weight``, is sown.  ``group``
    (:func:`global_routing`) routes over every rank's tokens.  Split over
    an expert group (``expert_group``; ``parallel.tensor_parallel``),
    ``w_in``/``w_out`` hold the experts from ``expert_start`` on."""

    def __init__(self, d_model: int, num_experts: int = 8,
                 mlp_dim: int = 2048, capacity_factor: float = 2.0,
                 dtype: torch.dtype = torch.float32,
                 aux_loss_weight: float = 1.0):
        super().__init__()
        self.num_experts, self.capacity_factor = num_experts, capacity_factor
        self.dtype, self.aux_loss_weight = dtype, aux_loss_weight
        self.router = Dense(d_model, num_experts)
        self.w_in = nn.Parameter(torch.empty(num_experts, d_model, mlp_dim))
        self.w_out = nn.Parameter(torch.empty(num_experts, mlp_dim, d_model))
        self.group = None
        self.expert_group, self.expert_start = None, 0

    def reset_experts(self, generator: Optional[torch.Generator] = None):
        """flax's ``xavier_uniform`` on the expert kernels (the router is
        an ``nn.Linear``, initialised with the model's others)."""
        _xavier_uniform_(self.w_in, generator)
        _xavier_uniform_(self.w_out, generator)

    def capacity(self, tokens: int) -> int:
        """Slots an expert for ``tokens`` of this rank (the global count
        under a routing group): ``max(1, int(cf · G / E))``."""
        if self.group is not None:
            tokens *= dist.get_world_size(self.group)
        return max(1, int(self.capacity_factor * tokens / self.num_experts))

    def forward(self, x):
        B, T, d = x.shape
        G, dt = B * T, self.dtype
        tokens = x.reshape(G, d)
        logits = self.router(tokens.float())
        dispatch, combine, aux = top2_gating(logits, self.capacity(G),
                                             self.group)
        sow_loss(self.aux_loss_weight * aux)
        if self.expert_group is not None:
            # this rank's experts: the tokens and the gates are replicated,
            # so each rank's branch adds its part of their gradients
            lo, n = self.expert_start, self.w_in.shape[0]
            tokens = copy_to(tokens, self.expert_group)
            combine = copy_to(combine, self.expert_group)[:, lo:lo + n]
            dispatch = dispatch[:, lo:lo + n]
        # the products' outputs are what --remat-policy dots keeps (jax's
        # dots_saveable); the casts and the GELU between them recompute
        w_in = recomputable(self.w_in.to, dt)
        w_out = recomputable(self.w_out.to, dt)
        expert_in = torch.einsum("gec,gd->ecd", dispatch.to(dt),
                                 tokens.to(dt))
        h = recomputable(_gelu, torch.einsum("ecd,edm->ecm", expert_in,
                                             w_in))
        expert_out = torch.einsum("ecm,emd->ecd", h, w_out)
        out = torch.einsum("gec,ecd->gd", recomputable(combine.to, dt),
                           expert_out)
        out = reduce_from(out, self.expert_group)
        return out.reshape(B, T, d).float()


class MoETransformerLayer(TransformerLayer):
    """Pre-LN block whose MLP is a routed :class:`MoEMLP`: self-attention
    (the caller's ``attend``, as :class:`TransformerLayer`'s), dropout and
    the residual, then LayerNorm, the routed MLP, dropout and the
    residual.  LayerNorms at flax's ε 1e-6, returning ``dtype``."""

    def __init__(self, d_model: int, num_heads: int, num_experts: int,
                 mlp_dim: int, capacity_factor: float = 2.0,
                 dtype: torch.dtype = torch.float32,
                 aux_loss_weight: float = 1.0):
        super().__init__(d_model, num_heads, None, dtype=dtype)
        self.moe = MoEMLP(d_model, num_experts, mlp_dim, capacity_factor,
                          dtype, aux_loss_weight)

    def feed_forward(self, h):
        return self.moe(h)


class MoELM(_EncoderModel):
    """Masked-LM encoder with routed MLPs in every odd layer (the flax
    ``MoELM``): layer ``i`` is a :class:`MoETransformerLayer` when ``i %
    2 == 1``, else a dense :class:`TransformerLayer`; bidirectional
    attention over ``tokens != 0`` keys, a final LayerNorm and the tied
    f32 head (no MLM transform, unlike :class:`BertEncoder`).  The
    LayerNorms return ``dtype``; the residual stream is f32 from the
    first routed layer on, as in the flax model."""

    def __init__(self, vocab_size: int = 1024, num_layers: int = 4,
                 d_model: int = 256, num_heads: int = 4, mlp_dim: int = 1024,
                 num_experts: int = 8, capacity_factor: float = 2.0,
                 aux_loss_weight: float = 1e-2, *, max_len: int = 4096,
                 attention: str = "dense", dropout_rate: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__(vocab_size, d_model, num_heads, max_len, attention,
                         dropout_rate, dtype)
        self.num_layers = num_layers
        self.layers = nn.ModuleList(
            MoETransformerLayer(d_model, num_heads, num_experts, mlp_dim,
                                capacity_factor, dtype, aux_loss_weight)
            if i % 2 == 1 else
            TransformerLayer(d_model, num_heads, mlp_dim, dtype=dtype)
            for i in range(num_layers))
        self.final_norm = LayerNorm(d_model, eps=1e-6, dtype=dtype)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        super().reset_parameters(generator)
        for mod in self.modules():
            if isinstance(mod, MoEMLP):
                mod.reset_experts(generator)
        return self

    def forward(self, tokens, generator: Optional[torch.Generator] = None,
                remat: Optional[str] = None):
        x = self.stack(self.layers, self.embed(tokens),
                       self._drop(generator), remat, generator,
                       self_valid=tokens != 0)
        return self.logits_from(self.final_norm(x))


def global_routing(model: nn.Module, ranks=None) -> nn.Module:
    """Route every :class:`MoEMLP` of ``model`` over the global batch of a
    synced ``-m data`` step: one new process group over this rank's batch
    group (``ranks``, its ranks in every group, each a list: the batch
    axes of a mesh; default the whole world) when it has more than one
    rank; nothing when this rank's tokens are the batch.  Every rank
    makes every group, in one order."""
    layers = [m for m in model.modules() if isinstance(m, MoEMLP)]
    if not (layers and dist.is_initialized()):
        return model
    if ranks is None:
        ranks = [list(range(dist.get_world_size()))]
    mine = None
    for row in ranks:
        if len(row) > 1:
            group = dist.new_group(row)
            if dist.get_rank() in row:
                mine = group
    for mod in layers:
        mod.group = mine
    return model


def moe_param_rules(axis: str = "expert"):
    """Sharding rules for ``parallel.tensor_parallel``: the
    expert-stacked kernels split their leading ``E`` axis over ``axis``;
    the router stays replicated (every rank routes its own tokens)."""
    return ((r"(^|.*\.)w_in$", 0, axis),
            (r"(^|.*\.)w_out$", 0, axis))
