"""Pipeline-parallel transformer trunk: the port of
``distributed_deep_learning_tpu/parallel/pipeline_transformer.py``.

The homogeneous part of a language model, a stack of identical pre-LN
blocks, runs through the schedules of :mod:`.spmd_pipeline`; each stage
holds ``num_layers / (S·V)`` consecutive blocks.  :class:`PipelinedTrunk`
keeps every parameter stacked, ``(S, ...)`` or ``(V, S, ...)`` with
virtual stage ``v·S + s`` at ``[v, s]``, as the JAX package's trunk does,
so an optimizer sees JAX's layout: every trunk parameter has two axes or
more (AdamW and LAMB decay them all, as optax's ``ndim >= 2`` mask
does), LAMB's trust ratio and ``--clip-norm`` take the whole stack, and
Adafactor factors the stacked flax shape (:meth:`PipelinedTrunk.flax_layout`).
A stage is one :class:`TrunkStage` called through
``torch.func.functional_call`` on the slices of its stage.

On a data x stage grid of ranks (:class:`..runtime.mesh.PipelineGrid`)
:meth:`PipelinedTrunk.keep_stage` leaves a rank only its stage's slice of
each stacked parameter, ``(1, ...)`` or ``(V, 1, ...)``, marked as a
:class:`..parallel.shards.TensorShard` over the stage group: the clip's
global norm, LAMB's trust ratios and Adafactor's factors then take the
whole stacked leaf, as JAX's optimizers see it, and a checkpoint gathers
the whole leaf.

The trunk threads no padding mask (``key_valid`` is None), as the JAX
trunk does: pads are attended, so the flash kernels take no key mask.
"""

from __future__ import annotations

import copy
from typing import Optional

import torch
from torch import nn
from torch.func import functional_call

from distributed_deep_learning_tpu_torch.models.transformer import (
    TransformerLayer, attend_qkv, dropout, flax_layout, layer_flax_state,
    reset_linear_norm_)
from distributed_deep_learning_tpu_torch.parallel.shards import TensorShard
from distributed_deep_learning_tpu_torch.parallel.spmd_pipeline import \
    spmd_pipeline


class TrunkBlock(TransformerLayer):
    """One pre-LN self-attention block taking only its input: positions
    ``0..T-1``, ``attention`` (``dense`` or ``flash``) causal or not, with
    an optional sliding ``window``, no padding mask; the layer of the
    staged LM layer lists and of :class:`TrunkStage`."""

    def __init__(self, d_model: int, num_heads: int, mlp_dim: int, *,
                 causal: bool = False, attention: str = "dense",
                 rope: bool = False, window: Optional[int] = None,
                 num_kv_heads: Optional[int] = None):
        super().__init__(d_model, num_heads, mlp_dim,
                         num_kv_heads=num_kv_heads, rope=rope, causal=causal)
        self.attention, self.window = attention, window

    def forward(self, x, drop=None):
        def attend(q, k, v):
            return attend_qkv(self.attention, self.self_attn, q, k, v,
                              causal=self.causal, window=self.window)
        positions = torch.arange(x.shape[1], device=x.device)
        return super().forward(x, positions, attend, drop)

    def reset_parameters(self, generator=None):
        return reset_linear_norm_(self, generator)

    @staticmethod
    def flax_state(params, stats=None) -> dict:
        """The flax ``TransformerLayer`` subtree → this block's state."""
        return layer_flax_state(params, "")


class TrunkStage(nn.Module):
    """``layers_per_stage`` consecutive blocks: one pipeline stage.
    ``forward(x, generator)`` applies dropout after each sub-block (rate
    ``dropout_rate``) when given a generator, the (virtual stage,
    microbatch)'s."""

    def __init__(self, layers_per_stage: int, d_model: int, num_heads: int,
                 mlp_dim: int, *, causal: bool = False,
                 attention: str = "dense", dropout_rate: float = 0.0,
                 rope: bool = False, window: Optional[int] = None,
                 num_kv_heads: Optional[int] = None):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.blocks = nn.ModuleList(
            TrunkBlock(d_model, num_heads, mlp_dim, causal=causal,
                       attention=attention, rope=rope, window=window,
                       num_kv_heads=num_kv_heads)
            for _ in range(layers_per_stage))

    def forward(self, x, generator: Optional[torch.Generator] = None):
        drop = None
        if generator is not None and self.dropout_rate > 0:
            def drop(h):
                return dropout(h, self.dropout_rate, generator)
        for block in self.blocks:
            x = block(x, drop)
        return x


class PipelinedTrunk(nn.Module):
    """A transformer trunk of ``num_layers`` blocks over ``n_stages``
    stages, ``n_chunks`` chunks a stage (interleaved pipelining: virtual
    stage ``v·S + s`` on stage ``s``).  The stacked parameters live under
    ``stack`` with the block names of one stage (``stack.blocks.<i>...``)
    and leading axes ``(S,)`` or ``(V, S)``."""

    def __init__(self, num_layers: int, n_stages: int, *, d_model: int,
                 num_heads: int = 8, mlp_dim: int = 2048,
                 causal: bool = False,
                 microbatch_size: Optional[int] = None,
                 attention: str = "dense", dropout_rate: float = 0.0,
                 n_chunks: int = 1, rope: bool = False,
                 window: Optional[int] = None,
                 num_kv_heads: Optional[int] = None):
        super().__init__()
        if n_chunks < 1:
            raise ValueError(f"n_chunks must be >= 1, got {n_chunks}")
        n_virtual = n_stages * n_chunks
        if num_layers % n_virtual:
            raise ValueError(f"{num_layers} layers not divisible into "
                             f"{n_stages} stages x {n_chunks} chunks")
        self.n_stages, self.n_chunks = n_stages, n_chunks
        self.microbatch_size = microbatch_size
        self.lead = (n_stages,) if n_chunks == 1 else (n_chunks, n_stages)
        # the stage's code, called on each stage's slices; its own
        # parameters are never used, so they live on the meta device and
        # outside the module tree
        with torch.device("meta"):
            stage = TrunkStage(num_layers // n_virtual, d_model, num_heads,
                               mlp_dim, causal=causal, attention=attention,
                               dropout_rate=dropout_rate, rope=rope,
                               window=window, num_kv_heads=num_kv_heads)
        self._stage = [stage]
        self.stack = copy.deepcopy(stage)
        for name, p in list(self.stack.named_parameters()):
            mod_name, _, leaf = name.rpartition(".")
            setattr(self.stack.get_submodule(mod_name), leaf, nn.Parameter(
                torch.empty(*self.lead, *p.shape, device="cpu")))

    @property
    def stage(self) -> TrunkStage:
        return self._stage[0]

    def stacked(self) -> dict:
        """``{name: stacked parameter}`` with one stage's names."""
        return dict(self.stack.named_parameters())

    def stage_params(self, v: int) -> dict:
        """Virtual stage ``v``'s slices."""
        return {k: p[self._index(v)] for k, p in self.stacked().items()}

    def stage_fn(self, params: dict, x,
                 generator: Optional[torch.Generator] = None):
        """One stage's ``(params, x, generator) -> y``: the unit every
        schedule applies per tick."""
        return functional_call(self.stage, params, (x,),
                               {"generator": generator})

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Each virtual stage initialised on its own, as the JAX trunk
        initialises stage ``i`` from ``fold_in(rng, i)``: Xavier-uniform
        projections, zero biases, unit LayerNorm scales."""
        block = copy.deepcopy(self.stage.blocks[0]).to_empty(device="cpu")
        stacked = self.stacked()
        with torch.no_grad():
            for v in range(self.n_stages * self.n_chunks):
                for i in range(len(self.stage.blocks)):
                    block.reset_parameters(generator)
                    for k, p in block.named_parameters():
                        stacked[f"blocks.{i}.{k}"][self._index(v)].copy_(p)
        return self

    def _index(self, v: int):
        return v if self.n_chunks == 1 else (v // self.n_stages,
                                             v % self.n_stages)

    def keep_stage(self, grid) -> "PipelinedTrunk":
        """Keep only ``grid.stage``'s slice of every stacked parameter
        (the stage axis is dim 0, or dim 1 under ``(V, S, ...)``), each a
        :class:`TensorShard` over ``grid.stage_group`` when the grid has
        more than one stage."""
        dim = len(self.lead) - 1
        s = grid.stage
        for name, p in list(self.stack.named_parameters()):
            mod_name, _, leaf = name.rpartition(".")
            part = nn.Parameter(p.detach().narrow(dim, s, 1).clone())
            if grid.stages > 1:
                part.tp_shard = TensorShard(dim=dim, index=s,
                                            parts=grid.stages,
                                            group=grid.stage_group,
                                            axis="stage")
            setattr(self.stack.get_submodule(mod_name), leaf, part)
        return self

    def flax_layout(self, name: str):
        """``(to_flax, from_flax)`` of a stacked parameter: one block's
        flax layout (:func:`..models.transformer.flax_layout`) on each
        slice, the leading axes kept."""
        head_dim = self.stage.blocks[0].self_attn.head_dim
        to_flax, from_flax = flax_layout(name, head_dim)
        n = len(self.lead)

        def lift(fn):
            def apply(t):
                flat = t.reshape(-1, *t.shape[n:])
                out = torch.stack([fn(s) for s in flat])
                return out.reshape(*t.shape[:n], *out.shape[1:])
            return apply
        return lift(to_flax), lift(from_flax)

    def apply(self, x, seed: Optional[int] = None,
              remat: Optional[str] = None):
        """``(B, T, d)`` through every stage, pipelined (GPipe); ``seed``
        switches dropout on.  With ``n_chunks > 1`` the forward laps the
        S-stage pipeline V times (chunk ``v`` of every stage is lap
        ``v``)."""
        stacked = self.stacked()
        for v in range(self.n_chunks):
            lap = stacked if self.n_chunks == 1 else \
                {k: p[v] for k, p in stacked.items()}
            x = spmd_pipeline(self.stage_fn, lap, x,
                              microbatch_size=self.microbatch_size,
                              seed=seed, stage_offset=v * self.n_stages,
                              remat=remat)
        return x

    def apply_sequential(self, x):
        """The same stages one after another without the pipeline (no
        dropout)."""
        for v in range(self.n_stages * self.n_chunks):
            x = self.stage_fn(self.stage_params(v), x)
        return x
