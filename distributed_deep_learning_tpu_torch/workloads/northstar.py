"""The north-star workloads: the port of
``distributed_deep_learning_tpu/workloads/northstar.py`` for ``resnet``,
``transformer`` (WMT seq2seq), ``bert`` (C4 MLM), ``moe`` (the
sparse-expert MLM) and ``gpt`` (decoder-only causal LM)::

    python -m distributed_deep_learning_tpu_torch resnet -s 50 -e 1 -b 32
    python -m distributed_deep_learning_tpu_torch transformer -l 6 -s 512
    python -m distributed_deep_learning_tpu_torch bert -l 12 -s 768
    python -m distributed_deep_learning_tpu_torch moe -l 4 -s 256
    python -m distributed_deep_learning_tpu_torch gpt -m sequential -e 1
    python -m distributed_deep_learning_tpu_torch gpt -e 1 --generate 16 \\
        --serve [--paged]

``-l`` is the layer count, ``-s`` the ResNet depth (18/34/50) or the model
width.  ``resnet`` trains on the synthetic CIFAR-10 twin, or on an
ImageFolder tree under ``--data-dir`` decoded at ``--image-size`` in
``-w`` threads (8 by default), with SGD momentum 0.9 at lr 0.1 unless
``--lr`` is given; the stem is the 3×3 CIFAR stem for images of at most
64 px, else the 7×7 one or, under ``--stem-s2d``, its space-to-depth
form.  ``transformer`` (source and target 32 ids) and ``bert`` (T 64,
masked sites only) train on their synthetic twins over a 1024-id
vocabulary unless ``--data-dir`` holds a ``tokens.npy``; both take AdamW.
``moe`` trains on ``bert``'s data with AdamW: ``models.moe.MoELM``, 8
experts top-2 in every odd layer, its load-balance loss added to the
objective, routed over the global batch under ``-m data``; the staged
modes refuse it, as the JAX package does.
``gpt``: synthetic T=64, vocabulary-1024 data unless ``--data-dir`` holds
a ``tokens.npy``.  ``--attention auto`` resolves to the flash kernels on
``cuda`` and to dense attention on the CPU (the TPU package's
measured-speedup gate does not carry over to this card), for the
encoder's, decoder's and cross-attention alike.  ``--packed-cache``
replaces any of these datasets (:func:`..base.build_dataset`).  After
``gpt`` trains, ``--generate N`` logs greedy continuations of two dataset
prompts and ``--serve`` serves a seeded trace through the slot engine
(``--paged``: the paged engine, ``--draft N`` speculating with its first N
layers), both on the trained weights at the run's ``--dtype``, the KV
cache and weights stored as ``--kv-dtype`` and ``--weight-dtype`` say.
``--serve-deadline-ms``, ``--reload-watch`` or ``--admission`` run the
engine under its supervisor; ``--priority-classes`` turns preemption on
(``--migrate``, ``--spill-dir``); ``--replicas N`` serves through the
fleet router (``--evacuate-on``, ``--autoscale``).

``-m model`` stages each workload's layer list: ResNet's stem, blocks and
head, and for the LMs an embedding, the blocks and a head attending
densely, as the JAX package's lists do.  ``-m pipeline`` stages ResNet
the same way and runs the LMs as :class:`..models.pipelined_lm.PipelinedLM`
(``transformer``: a decoder-only causal LM over source⊕target read at
the target positions; ``bert``: a bidirectional trunk with an untied
head; ``gpt``: its options but the padding mask), whose trunk takes the
flash kernels under ``--attention auto`` on ``cuda``.  After a staged
run ``--generate`` and ``--serve`` are skipped with JAX's notice.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from distributed_deep_learning_tpu_torch import resolve_device
from distributed_deep_learning_tpu_torch.data.datasets import (
    ArrayDataset, synthetic_c4_mlm, synthetic_cifar10, synthetic_lm,
    synthetic_wmt)
from distributed_deep_learning_tpu_torch.data.tokens import (lm_dataset,
                                                             load_tokens,
                                                             mlm_dataset,
                                                             seq2seq_dataset)
from distributed_deep_learning_tpu_torch.models.moe import MoELM
from distributed_deep_learning_tpu_torch.models.pipelined_lm import (
    LMEmbed, LMHead, PipelinedLM)
from distributed_deep_learning_tpu_torch.models.resnet import (
    BasicBlock, BottleneckBlock, ResNet, resnet_layer_sequence)
from distributed_deep_learning_tpu_torch.models.transformer import (
    BertEncoder, CausalLM, Seq2SeqAdapter, TransformerSeq2Seq, generate)
from distributed_deep_learning_tpu_torch.train.objectives import (
    RowMean, TokenCrossEntropy, cross_entropy_loss)
from distributed_deep_learning_tpu_torch.train.state import Optimizer
from distributed_deep_learning_tpu_torch.parallel.partition import \
    balanced_partition
from distributed_deep_learning_tpu_torch.parallel.pipeline_transformer \
    import TrunkBlock
from distributed_deep_learning_tpu_torch.utils.config import (Config, Mode,
                                                              parse_args)
from distributed_deep_learning_tpu_torch.workloads.base import (
    WorkloadSpec, adamw, config_dtype, example_shape, nchw_input,
    resolve_lr, run_workload)

_RESNET_LAYERS = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3)}


# --- resnet ----------------------------------------------------------------

def _resnet_dataset(config: Config):
    """An ImageFolder tree under ``--data-dir`` (decoded at
    ``--image-size`` in ``-w`` threads, 8 by default), the synthetic
    CIFAR-10 twin otherwise."""
    if config.data_dir:
        from distributed_deep_learning_tpu_torch.data.imagefolder import \
            ImageFolderDataset

        return ImageFolderDataset(config.data_dir,
                                  image_size=config.image_size,
                                  num_workers=config.num_workers or 8)
    return synthetic_cifar10(seed=config.seed)


def _resnet_geometry(config: Config, dataset):
    """``(depth, classes, small)``: ``-s`` when it names a depth (else 18),
    the dataset's class count (10 when it carries none, as a packed twin
    does), and the small stem for images of at most 64 px, read from the
    feature array where there is one (twins, ``--packed-cache``) and from
    ``--image-size`` for the ImageFolder's lazy decode."""
    depth = config.size if config.size in _RESNET_LAYERS else 18
    num_classes = len(getattr(dataset, "classes", ())) or 10
    feats = getattr(dataset, "features", None)
    if feats is not None and feats.ndim == 4:
        small = feats.shape[1] <= 64
    else:
        small = config.image_size <= 64 if config.data_dir else True
    return depth, num_classes, small


def _resnet_model(config: Config, dataset) -> ResNet:
    depth, num_classes, small = _resnet_geometry(config, dataset)
    return ResNet(stage_sizes=_RESNET_LAYERS[depth],
                  block_cls=BottleneckBlock if depth >= 50 else BasicBlock,
                  num_classes=num_classes, small_inputs=small,
                  stem_s2d=config.stem_s2d and not small,
                  dtype=config_dtype(config))


def _resnet_layers(config: Config, dataset):
    if config.stem_s2d:
        raise ValueError("--stem-s2d: the staged ResNet's stem has no "
                         "space-to-depth form (the JAX package runs the 7x7 "
                         "stem there); drop the flag or use -m data")
    depth, num_classes, small = _resnet_geometry(config, dataset)
    return resnet_layer_sequence(
        stage_sizes=_RESNET_LAYERS[depth],
        block_cls=BottleneckBlock if depth >= 50 else BasicBlock,
        num_classes=num_classes, width=64, small_inputs=small,
        in_channels=example_shape(dataset)[-1])


RESNET_SPEC = WorkloadSpec(
    name="resnet",
    build_dataset=_resnet_dataset,
    build_model=_resnet_model,
    build_loss=lambda c: RowMean(cross_entropy_loss),
    build_layers=_resnet_layers,
    partitioner=balanced_partition,
    stage_input=nchw_input,
    # optax.sgd(lr, momentum=0.9), lr 0.1 unless --lr moves it off 1e-3
    build_optimizer=lambda c, steps: Optimizer("momentum", resolve_lr(
        c, steps, c.learning_rate if c.learning_rate != 1e-3 else 0.1)),
)


def _token_ce_loss(c: Config):
    """Token cross-entropy with ``--label-smoothing`` (pad id 0 excluded)."""
    return TokenCrossEntropy(label_smoothing=c.label_smoothing)


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


def _n_chunks(config: Config) -> int:
    """Chunks a stage of the interleaved schedule (1 for gpipe/1f1b)."""
    return (config.virtual_stages
            if config.pipeline_schedule == "interleaved" else 1)


def _lm_geometry(config: Config, dataset):
    """``(d_model, heads, mlp_dim, src_len, tgt_len)`` of the LM variants."""
    d = config.size
    tgt_len = dataset.targets.shape[1]
    src_len = dataset.features.shape[1] - tgt_len
    return d, max(2, d // 64), 4 * d, src_len, tgt_len


def _pipelined(config: Config, dataset, n_stages: int, **kw) -> PipelinedLM:
    d = config.size
    return PipelinedLM(vocab_size=_vocab(dataset),
                       num_layers=config.num_layers, d_model=d,
                       num_heads=max(2, d // 64), mlp_dim=4 * d,
                       n_stages=n_stages, microbatch_size=config.microbatch,
                       dtype=config_dtype(config),
                       attention=_attention_fn(config),
                       dropout_rate=config.dropout,
                       n_chunks=_n_chunks(config), **kw)


def _lm_layers(config: Config, dataset, name: str, *, causal: bool,
               take=None, max_len: int = 4096, **block_kw):
    """``-m model``'s LM layer list of workload ``name``: embedding,
    blocks attending densely (the JAX lists pass no attention function),
    head."""
    if config.attention == "flash":
        raise ValueError(f"--attention flash: the staged layer list of "
                         f"{name!r} attends densely, as the JAX package's "
                         "does; use -m pipeline for the flash kernels")
    d, heads, mlp, _, _ = _lm_geometry(config, dataset)
    vocab = _vocab(dataset)
    pos = "rope" if block_kw.get("rope") else "learned"
    return [LMEmbed(vocab, d, max_len, config_dtype(config), pos)] + [
        TrunkBlock(d, heads, mlp, causal=causal, **block_kw)
        for _ in range(config.num_layers)] + [LMHead(d, vocab, take)]


# --- transformer (WMT seq2seq) --------------------------------------------

def _wmt_dataset(config: Config, src_len: int = 32, tgt_len: int = 32,
                 vocab: int = 1024):
    """``tokens.npy`` rows split at ``T // 2`` under ``--data-dir``, the
    synthetic WMT twin otherwise; features are source ⊕ target ids."""
    if config.data_dir:
        tokens = load_tokens(config.data_dir)
        if tokens is not None:
            return seq2seq_dataset(tokens)
    ds = synthetic_wmt(src_len=src_len, tgt_len=tgt_len, vocab_size=vocab,
                       seed=config.seed)
    feats = np.concatenate([ds.features, ds.targets], axis=1)
    return ArrayDataset(feats, ds.targets)


def _transformer_model(config: Config, dataset) -> Seq2SeqAdapter:
    d = config.size
    inner = TransformerSeq2Seq(
        vocab_size=_vocab(dataset), num_layers=config.num_layers,
        d_model=d, num_heads=max(2, d // 64), mlp_dim=4 * d,
        attention=_attention_fn(config), dropout_rate=config.dropout,
        dtype=config_dtype(config))
    src_len = dataset.features.shape[1] - dataset.targets.shape[1]
    return Seq2SeqAdapter(inner, src_len)


def _transformer_pipelined(config: Config, dataset, n_stages: int):
    """A decoder-only causal LM over source⊕target, its head reading the
    target positions (``take = (src_len - 1, tgt_len)``)."""
    _, _, _, src_len, tgt_len = _lm_geometry(config, dataset)
    return _pipelined(config, dataset, n_stages, causal=True,
                      head_take=(src_len - 1, tgt_len))


def _tp_rules(config: Config):
    """The Megatron rules of the transformer family (``--mesh model=K``)."""
    from distributed_deep_learning_tpu_torch.parallel.tensor_parallel \
        import transformer_tp_rules

    return transformer_tp_rules()


def _moe_rules(config: Config):
    """The experts over ``expert``; everything else replicated (the JAX
    spec's choice: its dense blocks keep no Megatron rules)."""
    from distributed_deep_learning_tpu_torch.models.moe import \
        moe_param_rules

    return moe_param_rules()


def _transformer_layers(config: Config, dataset):
    _, _, _, src_len, tgt_len = _lm_geometry(config, dataset)
    return _lm_layers(config, dataset, "transformer", causal=True,
                      take=(src_len - 1, tgt_len))


TRANSFORMER_SPEC = WorkloadSpec(
    name="transformer",
    build_dataset=_wmt_dataset,
    build_model=_transformer_model,
    build_loss=_token_ce_loss,
    build_layers=_transformer_layers,
    partitioner=balanced_partition,
    build_pipelined=_transformer_pipelined,
    build_optimizer=lambda c, steps: adamw(
        resolve_lr(c, steps, c.learning_rate)),
    token_ce=True,
    tp_rules=_tp_rules,
)


# --- bert (C4 MLM) ---------------------------------------------------------

def _mlm_dataset(config: Config, vocab: int = 1024, mask_id: int = 103):
    """``mlm_dataset`` over ``tokens.npy`` under ``--data-dir``, the
    synthetic C4 twin otherwise, its targets kept only at the masked
    sites (0, ignored, elsewhere)."""
    if config.data_dir:
        tokens = load_tokens(config.data_dir)
        if tokens is not None:
            return mlm_dataset(tokens, mask_id=mask_id, seed=config.seed)
    ds = synthetic_c4_mlm(vocab_size=vocab, mask_id=mask_id, seed=config.seed)
    targets = np.where(ds.features == mask_id, ds.targets, 0)
    return ArrayDataset(ds.features, targets.astype(np.int32))


def _bert_model(config: Config, dataset) -> BertEncoder:
    d = config.size
    return BertEncoder(vocab_size=_vocab(dataset),
                       num_layers=config.num_layers, d_model=d,
                       num_heads=max(2, d // 64), mlp_dim=4 * d,
                       attention=_attention_fn(config),
                       dropout_rate=config.dropout,
                       dtype=config_dtype(config))


def _bert_pipelined(config: Config, dataset, n_stages: int) -> PipelinedLM:
    """A bidirectional trunk and an untied MLM head (the full
    ``BertEncoder``'s tied head stays in ``-m sequential|data``)."""
    return _pipelined(config, dataset, n_stages, causal=False)


def _bert_layers(config: Config, dataset):
    return _lm_layers(config, dataset, "bert", causal=False)


BERT_SPEC = WorkloadSpec(
    name="bert",
    build_dataset=_mlm_dataset,
    build_model=_bert_model,
    build_loss=_token_ce_loss,
    build_layers=_bert_layers,
    partitioner=balanced_partition,
    build_pipelined=_bert_pipelined,
    build_optimizer=lambda c, steps: adamw(
        resolve_lr(c, steps, c.learning_rate)),
    token_ce=True,
    tp_rules=_tp_rules,
)


# --- moe (sparse-expert MLM) -----------------------------------------------

def _moe_model(config: Config, dataset) -> MoELM:
    d = config.size
    return MoELM(vocab_size=_vocab(dataset), num_layers=config.num_layers,
                 d_model=d, num_heads=max(2, d // 64), mlp_dim=4 * d,
                 num_experts=8, attention=_attention_fn(config),
                 dropout_rate=config.dropout, dtype=config_dtype(config))


def _moe_no_staging(config: Config, dataset):
    raise ValueError(
        "moe parallelises over experts, not stages: use -m data with "
        "--mesh expert=K (staged modes would drop the router's "
        "load-balance aux loss)")


MOE_SPEC = WorkloadSpec(
    name="moe",
    build_dataset=_mlm_dataset,
    build_model=_moe_model,
    build_loss=_token_ce_loss,
    build_layers=_moe_no_staging,
    build_optimizer=lambda c, steps: adamw(
        resolve_lr(c, steps, c.learning_rate)),
    token_ce=True,
    tp_rules=_moe_rules,
)


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


def _gpt_layers(config: Config, dataset):
    """``-m model``: embedding, causal blocks, a head at every position."""
    return _lm_layers(config, dataset, "gpt", causal=True,
                      max_len=max(dataset.features.shape[1], 8),
                      rope=config.pos_embedding == "rope",
                      window=config.attention_window,
                      num_kv_heads=config.num_kv_heads)


def _gpt_pipelined(config: Config, dataset, n_stages: int) -> PipelinedLM:
    return _pipelined(config, dataset, n_stages, causal=True,
                      max_len=max(dataset.features.shape[1], 4096),
                      pos_embedding=config.pos_embedding,
                      attention_window=config.attention_window,
                      num_kv_heads=config.num_kv_heads)


#: prompt length _gpt_generate slices from the dataset (rows 0-1)
_GENERATE_PROMPT_LEN = 8


def _gpt_pre_check(config: Config, dataset) -> None:
    """Reject an impossible ``--generate N`` before training: generate()
    checks prompt + N <= max_len itself, but only after training.  The
    staged modes are exempt: :func:`_gpt_post` skips generation there."""
    if not config.generate_tokens or config.mode in (Mode.MODEL,
                                                     Mode.PIPELINE):
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


def _serve_supervision_kw(config: Config) -> dict | None:
    """Supervisor kwargs when any serve-resilience knob is on the CLI
    (``--serve-deadline-ms`` / ``--reload-watch`` / ``--admission``);
    ``None`` means run the engine bare.  ``--serve-retries`` and
    ``--canary-slots`` only shape behaviour once one of the trigger
    knobs is set."""
    if (config.serve_deadline_ms is None and not config.reload_watch
            and config.admission is None):
        return None
    return dict(deadline_ms=config.serve_deadline_ms,
                retries=config.serve_retries,
                reload_watch=config.reload_watch,
                canary_slots=config.canary_slots,
                admission=config.admission)


def _log_supervision(logger, sv: dict) -> None:
    """One log line for the supervisor-level outcome (the engine-level
    line still follows from ``stats["engine"]``), JAX's."""
    line = (f"serve(supervised): restarts={sv['restarts']}, lost="
            f"{sv['requests_lost']}, deadline_misses="
            f"{sv['deadline_misses']}, ticks={sv['ticks']}")
    r = sv.get("reload")
    if r:
        line += (f", reload swaps={r['swaps']} rollbacks={r['rollbacks']}"
                 f" rejected={r['rejected']}")
    a = sv.get("admission")
    if a:
        line += f", admission level={a['level']} shed={a['shed_total']}"
    logger.info(line)


def _gpt_serve(config: Config, state, logger, dataset) -> None:
    """``--serve``: a seeded mixed-length request trace (prompts drawn over
    the dataset's vocabulary) through the slot engine on the trained
    weights, logging tokens/s, mean slot occupancy and the decode tick's
    captures; with ``--paged`` through the paged engine
    (:func:`_gpt_serve_paged`).  Any supervision knob runs the engine
    under :class:`..serve.supervisor.ServeSupervisor` and logs JAX's
    ``serve(supervised)`` line first."""
    from distributed_deep_learning_tpu_torch.serve.bench import (
        make_trace, run_engine, run_supervised)

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
    engine_kw = dict(device=next(model.parameters()).device,
                     max_slots=config.max_slots, kv_dtype=config.kv_dtype,
                     weight_dtype=config.weight_dtype)
    sup_kw = _serve_supervision_kw(config)
    if sup_kw is None:
        s = run_engine(model, trace, **engine_kw)["stats"]
    else:
        out = run_supervised(model, trace, **engine_kw, **sup_kw)
        _log_supervision(logger, out["stats"])
        s = out["stats"]["engine"]
        if s is None:
            return
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
        make_trace, paged_max_len, run_paged, run_supervised)

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
    engine_kw = dict(device=next(model.parameters()).device,
                     max_slots=config.max_slots, max_len=cap,
                     kv_block_size=block,
                     prefill_chunk=min(config.prefill_chunk, cap),
                     draft_layers=draft, spec_k=config.spec_k,
                     kv_dtype=config.kv_dtype,
                     weight_dtype=config.weight_dtype)
    if config.priority_classes:
        # a seeded priority mix over the same trace, and engine-side
        # preemption so the mix has teeth: low-priority slots spill
        pcs = config.priority_classes
        rng = np.random.default_rng(config.seed)
        fr = np.asarray([f for _, f in pcs]) / sum(f for _, f in pcs)
        trace = [dataclasses.replace(r, priority=int(
            rng.choice([p for p, _ in pcs], p=fr))) for r in trace]
        engine_kw.update(preempt=True, spill_dir=config.spill_dir,
                         migrate=config.migrate)
    if config.disagg:
        _gpt_serve_disagg(config, model, logger, trace, engine_kw)
        return
    if config.replicas > 1:
        _gpt_serve_fleet(config, model, logger, trace, engine_kw)
        return
    sup_kw = _serve_supervision_kw(config)
    if sup_kw is None:
        s = run_paged(model, trace, **engine_kw)["stats"]
    else:
        out = run_supervised(model, trace, paged=True, **engine_kw,
                             **sup_kw)
        _log_supervision(logger, out["stats"])
        s = out["stats"]["engine"]
        if s is None:
            return
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


def local_devices(config: Config) -> list:
    """The devices ``--disagg`` splits into its pools: the visible CUDA
    devices, or the one CPU (JAX's ``jax.local_devices()``)."""
    import torch

    from distributed_deep_learning_tpu_torch.utils.config import \
        local_device_count

    if config.device == "cpu":
        return [torch.device("cpu")]
    return [torch.device("cuda", i)
            for i in range(local_device_count(config.device))]


def _gpt_serve_disagg(config: Config, model, logger, trace,
                      engine_kw: dict) -> None:
    """``--serve --paged --disagg``: the same trace through the
    disaggregated engine (:mod:`..serve.disagg`), a prefill pool and a
    decode pool joined by per-prompt KV-block migration; JAX's
    ``serve(disagg):`` line, and under ``--pool-elastic`` the pool
    rebalancer's verdict on the run's ``prefill_util``."""
    from distributed_deep_learning_tpu_torch.serve.disagg import \
        DisaggEngine

    if config.draft:
        logger.info("serve(disagg): --draft ignored (speculation runs "
                    "on the unified engine only)")
    devices = local_devices(config)
    ndev = len(devices)
    eng = DisaggEngine(
        model, prefill_workers=config.prefill_workers,
        decode_workers=max(1, ndev - config.prefill_workers),
        max_slots=engine_kw["max_slots"], max_len=engine_kw["max_len"],
        kv_block_size=engine_kw["kv_block_size"],
        prefill_chunk=engine_kw["prefill_chunk"],
        kv_dtype=engine_kw["kv_dtype"],
        weight_dtype=engine_kw["weight_dtype"], devices=devices)
    out = eng.run(list(trace))
    s = out["stats"]
    mig = s["migration"]
    logger.info(
        f"serve(disagg): {s['requests']} requests, "
        f"{s['generated_tokens']} tokens at "
        f"{s['tokens_per_sec']:.1f} tok/s over "
        f"{config.prefill_workers}P+{max(1, ndev - config.prefill_workers)}D, "
        f"prefill util {s['prefill_util']:.2f}, migrated "
        f"{mig['moves']} handoffs ({mig['wire_bytes']} B), decode "
        f"captures={s['decode_captures']} ticks={s['decode_ticks']} "
        f"launches={s['paged_decode_launches']}")
    if config.pool_elastic:
        from distributed_deep_learning_tpu_torch.serve.autoscaler import \
            PoolRebalancer

        # the run-level prefill_util is the whole run's average: feed it
        # through the full patience window before actuating
        bal = PoolRebalancer()
        direction = None
        for _ in range(bal.patience):
            direction = bal.observe(s["prefill_util"])
        if direction and eng.reassign(direction):
            logger.info(
                f"serve(disagg): pool-elastic moved one worker "
                f"{direction.replace('_', ' ')} (prefill util "
                f"{s['prefill_util']:.2f}); pools now "
                f"{len(eng.prefill)}P+{len(eng.decode)}D")
        else:
            logger.info(
                f"serve(disagg): pool-elastic held the split "
                f"(prefill util {s['prefill_util']:.2f} inside the "
                f"hysteresis band, or no idle worker to move)")


def _gpt_serve_fleet(config: Config, model, logger, trace,
                     engine_kw: dict) -> None:
    """``--serve --paged --replicas N``: the same trace through N
    supervised paged replicas, sharing the model's weights, behind the
    prefix-affinity fleet router (:mod:`..serve.fleet`) — crash
    quarantine, zero-loss replay, per-priority SLO rollup, evacuation
    and autoscaling as the flags ask; logs JAX's ``serve(fleet)``
    line."""
    from distributed_deep_learning_tpu_torch.serve.admission import \
        AdmissionController
    from distributed_deep_learning_tpu_torch.serve.autoscaler import \
        FleetAutoscaler
    from distributed_deep_learning_tpu_torch.ops.paged_decode import \
        paged_flash_decode
    from distributed_deep_learning_tpu_torch.serve.engine import PagedEngine
    from distributed_deep_learning_tpu_torch.serve.fleet import FleetRouter

    engines = [PagedEngine(model, **engine_kw)
               for _ in range(config.replicas)]
    admissions = None
    if config.admission is not None:
        admissions = {i: AdmissionController(**config.admission)
                      for i in range(config.replicas)}
    autoscaler = engine_factory = None
    if config.autoscale is not None:
        autoscaler = FleetAutoscaler(**config.autoscale)
        # every grown replica serves the weights the fleet launched with,
        # at the launch geometry (so the decode's splits are the same)
        engine_factory = lambda: PagedEngine(model, **engine_kw)  # noqa: E731
    flt = FleetRouter(engines, deadline_ms=config.serve_deadline_ms,
                      retries=config.serve_retries, admissions=admissions,
                      evacuate_on=config.evacuate_on,
                      autoscaler=autoscaler, engine_factory=engine_factory)
    launches0 = paged_flash_decode.launches
    out = flt.run(list(trace))
    launches = paged_flash_decode.launches - launches0
    st = out["stats"]
    tokens = sum(len(v) for v in out["results"].values())
    line = (f"serve(fleet): {st['requests']} requests over "
            f"{len(engines)} replicas, {tokens} tokens, rounds="
            f"{st['rounds']}, lost={st['requests_lost']}, predicted hit "
            f"tokens {st['routing']['predicted_hit_tokens']}, decode "
            f"captures={max(v['decode_captures'] for v in st['per_replica'].values())} "
            f"launches={launches}")
    slo = st["slo"]
    if slo.get("slo_attainment") is not None:
        line += f", slo attainment {slo['slo_attainment']:.2f}"
        bp = slo.get("by_priority") or {}
        if bp:
            line += " (" + ", ".join(
                f"p{p}={s['slo_attainment']:.2f}" for p, s in
                sorted(bp.items()) if s["slo_attainment"] is not None) + ")"
    rb = st.get("rebalance")
    if rb and rb["evacuate_on"] != "off":
        line += (f", evacuated {rb['evacuated_slots']} slots "
                 f"({rb['evacuated_tokens']} tokens, "
                 f"{rb['rolled_back']} rolled back)")
    asc = st.get("autoscaler")
    if asc:
        line += (f", scale events {asc['scale_events']} "
                 f"(+{asc['grows']}/-{asc['shrinks']}, "
                 f"{asc['replicas_final']} final)")
    logger.info(line)


def _gpt_post(config: Config, state, logger, dataset) -> None:
    if config.mode in (Mode.MODEL, Mode.PIPELINE):
        # staged states hold per-stage or pipelined parameters, not the
        # CausalLM's: a notice after a finished run, as in JAX
        if config.generate_tokens:
            logger.info("generate skipped: --generate needs the whole-model "
                        "parameter tree (-m data or sequential)")
        if config.serve:
            logger.info("serve skipped: --serve needs the whole-model "
                        "parameter tree (-m data or sequential)")
        return
    if config.generate_tokens:
        _gpt_generate(config, state, logger, dataset)
    if config.serve:
        _gpt_serve(config, state, logger, dataset)


GPT_SPEC = WorkloadSpec(
    name="gpt",
    build_dataset=_gpt_dataset,
    build_model=_gpt_model,
    build_loss=_token_ce_loss,
    build_layers=_gpt_layers,
    partitioner=balanced_partition,
    build_pipelined=_gpt_pipelined,
    build_optimizer=lambda c, steps: adamw(
        resolve_lr(c, steps, c.learning_rate)),
    pre_train_check=_gpt_pre_check,
    post_train=_gpt_post,
    decoder_options=True,
    token_ce=True,
    tp_rules=_tp_rules,
)

SPECS = {"resnet": RESNET_SPEC, "transformer": TRANSFORMER_SPEC,
         "bert": BERT_SPEC, "moe": MOE_SPEC, "gpt": GPT_SPEC}


def main(argv=None, workload: str = "gpt"):
    return run_workload(SPECS[workload], parse_args(argv, workload=workload))
