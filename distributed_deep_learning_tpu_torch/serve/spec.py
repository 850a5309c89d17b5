"""Speculative decoding: a draft proposes, the target verifies.  The port of
``distributed_deep_learning_tpu/serve/spec.py``.

Plain decode is one target forward a token.  Speculation has a cheap DRAFT
propose ``k`` tokens one by one, then scores all ``k + 1`` positions in ONE
batched cached forward of the target and keeps the longest prefix of
proposals that matches the target's own greedy choices.

Greedy parity is exact.  With committed stream ``x_0..x_{c-1}`` and pending
token ``t``, the verify feeds ``[t, d_0 .. d_{k-1}]`` and yields the target's
argmaxes ``g_0..g_k``, ``g_j`` conditioned on the stream plus
``d_0..d_{j-1}``.  While every earlier proposal matched (``d_i = g_i``),
``g_j`` conditions on exactly the target's own greedy stream, so emitting
``g_0..g_a`` (``a`` the count of leading matches) emits what plain greedy
decode would have, the target's correction (or a bonus token when all
matched) included.  Acceptance changes speed, never a token.

The draft is a TRUNCATED view of the target: its first ``draft_layers``
layers with the embedding, the final norm and the tied head, sharing the
target's tensors, so it costs no parameter memory, only its own KV pools.
It runs ``k + 1`` steps a round: the last one writes the draft's K/V at
position ``c + k`` (its proposal is dropped), so a round where every
proposal is accepted leaves no hole in the draft's cache.
"""

from __future__ import annotations

import numpy as np
import torch

from distributed_deep_learning_tpu_torch.models.transformer import CausalLM


def truncated_draft(model: CausalLM, draft_layers: int) -> CausalLM:
    """A draft :class:`CausalLM` of the target's first ``draft_layers``
    layers, its embedding (the tied head), ``pos`` table and final norm:
    the target's own modules, no tensor copied."""
    n = model.num_layers
    if not 1 <= draft_layers < n:
        raise ValueError(
            f"draft_layers must be in [1, {n - 1}], got {draft_layers}")
    with torch.device("meta"):
        draft = CausalLM(
            vocab_size=model.vocab_size, num_layers=draft_layers,
            d_model=model.d_model, num_heads=model.num_heads,
            mlp_dim=model.mlp_dim, max_len=model.max_len,
            pos_embedding=model.pos_embedding,
            attention_window=model.attention_window,
            num_kv_heads=model.num_kv_heads, pad_id=model.pad_id,
            with_logits=model.with_logits, attention=model.attention,
            dtype=model.dtype)
    draft.tok, draft.final_norm = model.tok, model.final_norm
    draft.layers = torch.nn.ModuleList(model.layers[:draft_layers])
    del draft.pos
    draft.pos = model.pos
    return draft.train(model.training)


def greedy_accept(proposed, verified):
    """Host acceptance: the longest matching prefix plus the correction.

    ``proposed`` is the draft's ``k`` tokens ``d_0..d_{k-1}``, ``verified``
    the target's ``k + 1`` greedy tokens ``g_0..g_k``.  Returns ``(a,
    emitted)``: ``a`` accepted proposals and the ``a + 1`` tokens
    ``g_0..g_a`` to append (the accepted proposals, since ``d_j = g_j`` for
    ``j < a``, then the target's correction or bonus token)."""
    proposed = np.asarray(proposed)
    verified = np.asarray(verified)
    k = len(proposed)
    if len(verified) != k + 1:
        raise ValueError(
            f"verified must have k+1={k + 1} tokens, got {len(verified)}")
    a = 0
    while a < k and int(proposed[a]) == int(verified[a]):
        a += 1
    return a, [int(t) for t in verified[:a + 1]]
