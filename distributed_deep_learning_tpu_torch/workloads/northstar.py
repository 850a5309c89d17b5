"""The ``gpt`` workload (decoder-only causal LM): the port of the ``gpt``
part of ``distributed_deep_learning_tpu/workloads/northstar.py``::

    python -m distributed_deep_learning_tpu_torch gpt -m sequential -e 1
    python -m distributed_deep_learning_tpu_torch gpt -e 1 --generate 16 \\
        --serve [--paged]

Synthetic T=64, vocabulary-1024 data unless ``--data-dir`` holds a
``tokens.npy``.  ``--attention auto`` resolves to the flash kernels on
``cuda`` and to dense attention on the CPU (the TPU package's
measured-speedup gate does not carry over to this card).  After training,
``--generate N`` logs greedy continuations of two dataset prompts and
``--serve`` serves a seeded trace through the slot engine (``--paged``:
the paged engine, ``--draft N`` speculating with its first N layers), both
on the trained weights at the run's ``--dtype``, the KV cache and weights
stored as ``--kv-dtype`` and ``--weight-dtype`` say.
"""

from __future__ import annotations

import dataclasses

import torch

from distributed_deep_learning_tpu_torch import resolve_device
from distributed_deep_learning_tpu_torch.data.datasets import synthetic_lm
from distributed_deep_learning_tpu_torch.data.tokens import (lm_dataset,
                                                             load_tokens)
from distributed_deep_learning_tpu_torch.models.transformer import (CausalLM,
                                                                     generate)
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


#: prompt length _gpt_generate slices from the dataset (rows 0-1)
_GENERATE_PROMPT_LEN = 8


def _gpt_pre_check(config: Config, dataset) -> None:
    """Reject an impossible ``--generate N`` before training: generate()
    checks prompt + N <= max_len itself, but only after training."""
    if not config.generate_tokens:
        return
    max_len = max(dataset.features.shape[1], 8)  # mirrors _gpt_model
    prompt = min(_GENERATE_PROMPT_LEN, dataset.features.shape[1])
    if prompt + config.generate_tokens > max_len:
        raise ValueError(
            f"--generate {config.generate_tokens}: prompt {prompt} + new "
            f"tokens exceeds the model's max_len {max_len} (the dataset "
            f"sequence length); at most {max_len - prompt} tokens fit")


def _served_model(config: Config, state, dataset) -> CausalLM:
    """A fresh ``_gpt_model`` at the run's ``--dtype`` holding the trained
    weights, on the training device, in eval mode."""
    model = _gpt_model(config, dataset)
    model.load_state_dict(state.model.state_dict())
    return model.to(next(state.model.parameters()).device).eval()


def _gpt_generate(config: Config, state, logger, dataset) -> None:
    """``--generate N``: log KV-cached greedy continuations of two dataset
    prompts (rows 0-1, typically training rows: a smoke sample, not
    held-out evaluation) in the reference's quote-delimited log style."""
    model = _served_model(config, state, dataset)
    prompts = torch.as_tensor(
        dataset.features[:2, :_GENERATE_PROMPT_LEN], dtype=torch.int32,
        device=next(model.parameters()).device)
    out = generate(model, prompts, max_new_tokens=config.generate_tokens)
    for row_p, row_o in zip(prompts.tolist(), out.tolist()):
        logger.info(f"generate prompt={row_p} continuation={row_o}")


def _gpt_serve(config: Config, state, logger, dataset) -> None:
    """``--serve``: a seeded mixed-length request trace (prompts drawn over
    the dataset's vocabulary) through the slot engine on the trained
    weights, logging tokens/s, mean slot occupancy and the decode tick's
    captures; with ``--paged`` through the paged engine
    (:func:`_gpt_serve_paged`)."""
    from distributed_deep_learning_tpu_torch.serve.bench import (make_trace,
                                                                 run_engine)

    model = _served_model(config, state, dataset)
    seq = dataset.features.shape[1]
    # prompt + budget must fit the slot capacity (the model's max_len,
    # dataset-derived and possibly tiny in smoke runs)
    p_hi = max(2, min(_GENERATE_PROMPT_LEN, seq, model.max_len - 1))
    new_hi = max(1, min(config.generate_tokens or 16,
                        model.max_len - p_hi))
    if config.paged:
        _gpt_serve_paged(config, model, logger, dataset, p_hi, new_hi)
        return
    trace = make_trace(max(2 * config.max_slots, 8),
                       vocab_size=_vocab(dataset), seed=config.seed,
                       prompt_lens=(2, p_hi), new_tokens=(1, new_hi))
    s = run_engine(model, trace, device=next(model.parameters()).device,
                   max_slots=config.max_slots, kv_dtype=config.kv_dtype,
                   weight_dtype=config.weight_dtype)["stats"]
    logger.info(
        f"serve: {s['requests']} requests, {s['generated_tokens']} tokens "
        f"at {s['tokens_per_sec']:.1f} tok/s, occupancy "
        f"{s['mean_slot_occupancy']:.2f}/{s['max_slots']}, decode "
        f"captures={s['decode_captures']} ticks={s['decode_ticks']}")


def _gpt_serve_paged(config: Config, model, logger, dataset, p_hi: int,
                     new_hi: int) -> None:
    """``--serve --paged``: the same trace shape through the paged engine,
    with the config's block, chunk, draft, quantization and SLO settings;
    a ``--draft`` the model cannot take is logged and dropped."""
    from distributed_deep_learning_tpu_torch.serve.bench import (
        make_trace, paged_max_len, run_paged)

    draft = config.draft or None
    if draft is not None and not 1 <= draft < model.num_layers:
        logger.info(f"serve: --draft {draft} needs 1 <= draft < "
                    f"{model.num_layers} (the model's layer count); "
                    "speculation disabled")
        draft = None
    block = min(config.kv_block_size, model.max_len)
    try:
        cap = paged_max_len(model.max_len, block, draft is not None,
                            config.spec_k)
    except ValueError as exc:
        logger.info(f"serve: paged engine skipped ({exc})")
        return
    p_hi = max(2, min(p_hi, cap - 1))
    new_hi = max(1, min(new_hi, cap - p_hi))
    trace = make_trace(max(2 * config.max_slots, 8),
                       vocab_size=_vocab(dataset), seed=config.seed,
                       prompt_lens=(2, p_hi), new_tokens=(1, new_hi))
    if config.slo_ttft_ms or config.slo_e2e_ms:
        trace = [dataclasses.replace(r, slo_ttft_ms=config.slo_ttft_ms,
                                     slo_e2e_ms=config.slo_e2e_ms)
                 for r in trace]
    s = run_paged(model, trace, device=next(model.parameters()).device,
                  max_slots=config.max_slots, max_len=cap,
                  kv_block_size=block,
                  prefill_chunk=min(config.prefill_chunk, cap),
                  draft_layers=draft, spec_k=config.spec_k,
                  kv_dtype=config.kv_dtype,
                  weight_dtype=config.weight_dtype)["stats"]
    pg, sp, slo = s["paged"], s["spec"], s["slo"]
    line = (f"serve(paged): {s['requests']} requests, "
            f"{s['generated_tokens']} tokens at "
            f"{s['tokens_per_sec']:.1f} tok/s, prefix hit "
            f"{pg['prefix_hit_rate']:.3f}, cow {pg['cow_copies']}, "
            f"decode captures={s['decode_captures']} "
            f"ticks={s['decode_ticks']} "
            f"launches={s['paged_decode_launches']}")
    if sp["enabled"]:
        line += (f", draft captures={s['draft_captures']} verify "
                 f"captures={s['verify_captures']}")
        if sp["acceptance_rate"] is not None:
            line += f", spec acceptance {sp['acceptance_rate']:.3f}"
    if slo["slo_attainment"] is not None:
        line += f", slo attainment {slo['slo_attainment']:.2f}"
    logger.info(line)


def _gpt_post(config: Config, state, logger, dataset) -> None:
    if config.generate_tokens:
        _gpt_generate(config, state, logger, dataset)
    if config.serve:
        _gpt_serve(config, state, logger, dataset)


GPT_SPEC = WorkloadSpec(
    name="gpt",
    build_dataset=_gpt_dataset,
    build_model=_gpt_model,
    build_loss=_token_ce_loss,
    build_optimizer=lambda c, steps: adamw(
        resolve_lr(c, steps, c.learning_rate)),
    pre_train_check=_gpt_pre_check,
    post_train=_gpt_post,
)

SPECS = {"gpt": GPT_SPEC}


def main(argv=None, workload: str = "gpt"):
    return run_workload(SPECS[workload], parse_args(argv, workload=workload))
