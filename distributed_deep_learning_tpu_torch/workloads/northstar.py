"""The ``gpt`` workload (decoder-only causal LM): the port of the ``gpt``
part of ``distributed_deep_learning_tpu/workloads/northstar.py``::

    python -m distributed_deep_learning_tpu_torch gpt -m sequential -e 1

Synthetic T=64, vocabulary-1024 data unless ``--data-dir`` holds a
``tokens.npy``.  ``--attention auto`` resolves to the flash kernels on
``cuda`` and to dense attention on the CPU (the TPU package's
measured-speedup gate does not carry over to this card).
"""

from __future__ import annotations

import torch

from distributed_deep_learning_tpu_torch import resolve_device
from distributed_deep_learning_tpu_torch.data.datasets import synthetic_lm
from distributed_deep_learning_tpu_torch.data.tokens import (lm_dataset,
                                                             load_tokens)
from distributed_deep_learning_tpu_torch.models.transformer import CausalLM
from distributed_deep_learning_tpu_torch.train.objectives import \
    TokenCrossEntropy
from distributed_deep_learning_tpu_torch.utils.config import (Config,
                                                              parse_args)
from distributed_deep_learning_tpu_torch.workloads.base import (
    WorkloadSpec, adamw, resolve_lr, run_workload)


def _token_ce_loss(c: Config):
    """Token cross-entropy with ``--label-smoothing`` (pad id 0 excluded)."""
    return TokenCrossEntropy(label_smoothing=c.label_smoothing)


def config_dtype(config: Config) -> torch.dtype:
    """The compute dtype ``--dtype`` selects."""
    return torch.bfloat16 if config.dtype == "bfloat16" else torch.float32


def _attention_fn(config: Config) -> str:
    """Resolve ``--attention``: ``auto`` is the flash kernels on cuda and
    dense attention on the CPU; either can be forced (``flash`` on the CPU
    runs the kernels' plain versions)."""
    if config.attention != "auto":
        return config.attention
    return "flash" if resolve_device(config.device).type == "cuda" \
        else "dense"


def _vocab(dataset) -> int:
    """Carried by file-based token datasets, 1024 for the synthetic twin."""
    return int(getattr(dataset, "vocab_size", 1024))


def _gpt_dataset(config: Config, seq_len: int = 64, vocab: int = 1024):
    if config.data_dir:
        tokens = load_tokens(config.data_dir)
        if tokens is not None:
            return lm_dataset(tokens)
    return synthetic_lm(seq_len=seq_len, vocab_size=vocab, seed=config.seed)


def _gpt_model(config: Config, dataset) -> CausalLM:
    d = config.size
    return CausalLM(vocab_size=_vocab(dataset),
                    num_layers=config.num_layers, d_model=d,
                    num_heads=max(2, d // 64), mlp_dim=4 * d,
                    max_len=max(dataset.features.shape[1], 8),
                    pos_embedding=config.pos_embedding,
                    attention_window=config.attention_window,
                    num_kv_heads=config.num_kv_heads, with_logits=True,
                    attention=_attention_fn(config),
                    dropout_rate=config.dropout, dtype=config_dtype(config))


GPT_SPEC = WorkloadSpec(
    name="gpt",
    build_dataset=_gpt_dataset,
    build_model=_gpt_model,
    build_loss=_token_ce_loss,
    build_optimizer=lambda c, steps: adamw(
        resolve_lr(c, steps, c.learning_rate)),
)

SPECS = {"gpt": GPT_SPEC}


def main(argv=None, workload: str = "gpt"):
    return run_workload(SPECS[workload], parse_args(argv, workload=workload))
