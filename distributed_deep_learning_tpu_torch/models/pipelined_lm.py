"""Pipelined language models: the port of
``distributed_deep_learning_tpu/models/pipelined_lm.py``, the model the
``transformer``, ``bert`` and ``gpt`` workloads build for ``-m
pipeline``: embedding → :class:`..parallel.pipeline_transformer.PipelinedTrunk`
→ head.

As in the JAX package, the ``transformer`` workload's pipelined model is a
decoder-only causal LM over the source⊕target stream whose head reads the
target positions (``head_take``), and the head is untied.  Under
``model.train()`` with a dropout rate, :meth:`PipelinedLM.forward` draws a
seed from the generator it is given (a CPU generator: no device sync) and
each (virtual stage, microbatch) makes its own dropout generator from it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from distributed_deep_learning_tpu_torch.models.layers import as_tensor
from distributed_deep_learning_tpu_torch.models.transformer import (
    DTYPES, Dense, linear_flax_state)
from distributed_deep_learning_tpu_torch.parallel.pipeline_transformer import \
    PipelinedTrunk


class LMEmbed(nn.Module):
    """Token and learned positional embedding in the compute dtype;
    ``pos_embedding="rope"`` has no position table (the blocks rotate)."""

    def __init__(self, vocab_size: int, d_model: int, max_len: int = 4096,
                 dtype: torch.dtype = torch.float32,
                 pos_embedding: str = "learned"):
        super().__init__()
        self.dtype = dtype
        self.tok = nn.Embedding(vocab_size, d_model)
        self.pos = None if pos_embedding == "rope" else nn.Parameter(
            torch.empty(max_len, d_model))

    def reset_parameters(self, generator=None):
        """flax's N(0, 0.02) for the table and the positions."""
        with torch.no_grad():
            self.tok.weight.normal_(0.0, 0.02, generator=generator)
            if self.pos is not None:
                self.pos.normal_(0.0, 0.02, generator=generator)

    def forward(self, tokens):
        x = self.tok(tokens).to(self.dtype)
        if self.pos is None:
            return x
        return x + self.pos[:tokens.shape[1]].to(self.dtype)

    @staticmethod
    def flax_state(params, stats=None) -> dict:
        sd = {"tok.weight": as_tensor(params["tok"]["embedding"])}
        if "pos" in params:
            sd["pos"] = as_tensor(params["pos"])
        return sd


class LMHead(nn.Module):
    """Vocabulary projection (Xavier-uniform kernel, zero bias) in the
    input's dtype, f32 logits; ``take = (start, length)`` reads only those
    positions."""

    def __init__(self, d_model: int, vocab_size: int,
                 take: Optional[tuple[int, int]] = None):
        super().__init__()
        self.take = take
        self.dense = Dense(d_model, vocab_size)

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            fan_in, fan_out = self.dense.in_features, self.dense.out_features
            a = float(np.sqrt(6.0 / (fan_in + fan_out)))
            self.dense.weight.uniform_(-a, a, generator=generator)
            self.dense.bias.zero_()

    def forward(self, x):
        if self.take is not None:
            start, length = self.take
            x = x[:, start:start + length]
        return self.dense(x).float()

    @staticmethod
    def flax_state(params, stats=None) -> dict:
        return linear_flax_state(params["Dense_0"], "dense.")


class PipelinedLM(nn.Module):
    """embed → pipelined trunk (``n_stages`` stages, ``n_chunks`` chunks a
    stage) → head, with the flax ``PipelinedLM``'s fields; ``attention``
    is the trunk's (``dense`` or ``flash``)."""

    def __init__(self, *, vocab_size: int, num_layers: int, d_model: int,
                 num_heads: int, mlp_dim: int, n_stages: int,
                 causal: bool = False,
                 head_take: Optional[tuple[int, int]] = None,
                 microbatch_size: Optional[int] = None, max_len: int = 4096,
                 dtype: torch.dtype = torch.float32,
                 attention: str = "dense", dropout_rate: float = 0.0,
                 n_chunks: int = 1, pos_embedding: str = "learned",
                 attention_window: Optional[int] = None,
                 num_kv_heads: Optional[int] = None):
        super().__init__()
        if pos_embedding not in ("learned", "rope"):
            raise ValueError(f"pos_embedding must be 'learned' or 'rope', "
                             f"got {pos_embedding!r}")
        if attention_window is not None and not causal:
            raise ValueError("attention_window (sliding window) requires "
                             "a causal trunk")
        if dtype not in DTYPES:
            raise ValueError(f"unknown compute dtype {dtype}")
        self.dtype, self.dropout_rate = dtype, dropout_rate
        self.embed = LMEmbed(vocab_size, d_model, max_len, dtype,
                             pos_embedding)
        self.trunk = PipelinedTrunk(
            num_layers, n_stages, d_model=d_model, num_heads=num_heads,
            mlp_dim=mlp_dim, causal=causal, microbatch_size=microbatch_size,
            attention=attention, dropout_rate=dropout_rate,
            n_chunks=n_chunks, rope=pos_embedding == "rope",
            window=attention_window, num_kv_heads=num_kv_heads)
        self.head = LMHead(d_model, vocab_size, head_take)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.embed.reset_parameters(generator)
        self.trunk.reset_parameters(generator)
        self.head.reset_parameters(generator)
        return self

    def flax_layout(self, name: str):
        """``(to_flax, from_flax)`` of a parameter (Adafactor factors the
        flax shape): the trunk's stacked layout, the head's kernel
        transposed, the embedding as it is."""
        if name.startswith("trunk."):
            return self.trunk.flax_layout(name[len("trunk."):])
        if name == "head.dense.weight":
            return (lambda t: t.T, lambda t: t.T)
        return (lambda t: t, lambda t: t)

    def dropout_seed(self, generator: Optional[torch.Generator]):
        """The step's dropout seed drawn from ``generator`` in training
        mode with a dropout rate, else None."""
        if generator is None or not self.training or not self.dropout_rate:
            return None
        return int(torch.randint(0, 2 ** 62, (1,), generator=generator))

    def forward(self, tokens, generator: Optional[torch.Generator] = None,
                remat: Optional[str] = None):
        """Logits ``(B, T or take, V)`` in f32 through the GPipe trunk;
        ``remat`` recomputes each stage call in the backward."""
        x = self.trunk.apply(self.embed(tokens),
                             seed=self.dropout_seed(generator), remat=remat)
        return self.head(x)

    def apply_sequential(self, tokens):
        """Same weights without the pipeline (no dropout)."""
        return self.head(self.trunk.apply_sequential(self.embed(tokens)))


def stage_state_dict(state_dict: dict, stage: int, n_chunks: int = 1
                     ) -> dict:
    """Rank ``(d, stage)``'s state dict on a data x stage grid from a
    whole ``PipelinedLM`` state dict (``load_flax_params`` of JAX's
    params, or a one-process checkpoint's): slice ``stage`` of every
    stacked trunk leaf, ``[stage]`` kept as ``(1, ...)`` or ``[:, stage]``
    as ``(V, 1, ...)`` under ``n_chunks`` chunks, what
    :meth:`..parallel.pipeline_transformer.PipelinedTrunk.keep_stage`
    leaves a rank; the embedding and the head whole."""
    dim = 0 if n_chunks == 1 else 1
    return {k: v.narrow(dim, stage, 1).clone() if k.startswith("trunk.")
            else v for k, v in state_dict.items()}

