"""Run configuration and the workload CLI: the port of
``distributed_deep_learning_tpu/utils/config.py`` for the flags the port
runs (``gpt -m sequential|data``, ``--dtype``, every ``--optimizer``, the
step variants, checkpointing, and the post-train ``--generate`` and
``--serve [--paged]`` with speculation (``--draft``, ``--spec-k``) and
quantized serving (``--kv-dtype``, ``--weight-dtype``)).

Flag names, defaults, parse-time checks and the per-workload ``-l/-s``
defaults are the JAX CLI's, except ``-d``: ``cuda`` (the default; ``gpu``
is an alias) or ``cpu``.  ``--spawn`` is taken off the command line by
``__main__`` before parsing, as in the JAX package.  The JAX CLI's other
flags are accepted by the parser only to be refused: :func:`parse_args`
raises ``NotImplementedError`` naming the ``ROADMAP.md`` item that will
port them.
"""

from __future__ import annotations

import argparse
import dataclasses
import enum
from typing import Sequence

#: ``--remat-policy`` names, as the JAX CLI's; the model maps each to the
#: matmuls its backward keeps (``models.transformer.REMAT_SAVED_OPS``)
REMAT_POLICIES = ("nothing", "dots", "dots_no_batch")


class Mode(str, enum.Enum):
    """Execution mode, 1:1 with the reference CLI (``-m``)."""

    SEQUENTIAL = "sequential"
    MODEL = "model"
    PIPELINE = "pipeline"
    DATA = "data"

    def __str__(self) -> str:
        return self.value


@dataclasses.dataclass(frozen=True)
class Config:
    """One run's configuration (the JAX ``Config``'s fields this slice
    takes)."""

    num_layers: int = 1
    size: int = 38
    epochs: int = 10
    batch_size: int = 32
    device: str = "cuda"
    mode: Mode = Mode.SEQUENTIAL
    seed: int = 42
    learning_rate: float = 1e-3
    dtype: str = "float32"
    dropout: float = 0.0
    data_dir: str | None = None
    attention: str = "auto"
    attention_window: int | None = None
    optimizer: str = "auto"
    pos_embedding: str = "learned"
    num_kv_heads: int | None = None
    label_smoothing: float = 0.0
    lr_schedule: str = "none"
    warmup_steps: int | None = None
    clip_norm: float | None = None
    world_size: int = 1                 # -r: ranks of a -m data run
    sync_in_local_data_mode: bool = True  # False: --no-sync (quirk Q1)
    remat: bool = False
    remat_policy: str = "nothing"
    grad_accum: int = 1
    checkpoint_dir: str | None = None
    checkpoint_every: int = 0           # also save every N train steps
    resume: bool = False
    generate_tokens: int = 0            # gpt: sample N tokens post-train
    serve: bool = False                 # gpt: serve a trace post-train
    max_slots: int = 8                  # serving: concurrent decode slots
    prefill_buckets: tuple[int, ...] | None = None  # parsed as the JAX
                                                    #   CLI's; the port's
                                                    #   engines ignore it
    paged: bool = False                 # serving: the paged engine
    kv_block_size: int = 16             # paged serving: block tokens
    prefill_chunk: int = 32             # paged serving: chunk width
    draft: int = 0                      # paged serving: truncated-draft
                                        #   layers for speculation (0 = off)
    spec_k: int = 4                     # paged serving: draft tokens a round
    slo_ttft_ms: float | None = None    # serving: per-request TTFT SLO
    slo_e2e_ms: float | None = None     # serving: per-request e2e SLO
    kv_dtype: str | None = None         # serving: KV storage, bf16 or int8
                                        #   (int8: the paged engine only)
    weight_dtype: str | None = None     # serving: weight storage, bf16 or
                                        #   int8 (per-channel scales)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


#: per-workload -l/-s defaults, as in the JAX CLI
WORKLOAD_DEFAULTS: dict[str, dict[str, int]] = {
    "cnn": {"nlayers": 2, "size": 4},
    "lstm": {"nlayers": 1, "size": 128},
    "mlp": {"nlayers": 1, "size": 38},
    "mnist": {"nlayers": 2, "size": 32},
    "resnet": {"nlayers": 4, "size": 18},
    "transformer": {"nlayers": 6, "size": 512},
    "bert": {"nlayers": 12, "size": 768},
    "moe": {"nlayers": 4, "size": 256},
    "gpt": {"nlayers": 12, "size": 768},
}

#: ROADMAP.md queue 1 items that port what the port refuses
ROADMAP_ITEMS = {
    9: "ROADMAP.md queue 1 item 9 (the reference's workloads and the "
       "north-star zoo)",
    10: "ROADMAP.md queue 1 item 10 (model and pipeline modes)",
    11: "ROADMAP.md queue 1 item 11 (sharded parallelism)",
    12: "ROADMAP.md queue 1 item 12 (training resilience)",
    13: "ROADMAP.md queue 1 item 13 (serving resilience and fleet)",
    14: "ROADMAP.md queue 1 item 14 (observability, tuning, resharding)",
}

#: JAX CLI flags the port refuses -> the item that ports them; a
#: trailing "=" marks a flag that takes a value
UNPORTED_FLAGS = {
    "--publish-weights=": 13,
    "--packed-cache=": 9, "--image-size=": 9, "--stem-s2d": 9,
    "--double-softmax": 9,
    "--nstages=": 10, "--pipeline-schedule=": 10, "--virtual-stages=": 10,
    "--mesh=": 11, "--zero=": 11, "--grad-compress=": 11, "--comm=": 11,
    "--comm-overlap": 11,
    "--elastic": 12, "--sentinel=": 12, "--sentinel-window=": 12,
    "--sentinel-factor=": 12, "--heartbeat-dir=": 12,
    "--heartbeat-timeout=": 12,
    "--serve-deadline-ms=": 13, "--serve-retries=": 13,
    "--reload-watch=": 13, "--canary-slots=": 13, "--admission=": 13,
    "--replicas=": 13, "--priority-classes=": 13, "--spill-dir=": 13,
    "--autoscale=": 13, "--evacuate-on=": 13, "--disagg": 13,
    "--pool-elastic": 13, "--prefill-workers=": 13, "--migrate=": 13,
    "--reshard": 14, "--target-mesh=": 14, "--autotune": 14, "--plan=": 14,
    "--metrics-file=": 14, "--obs": 14, "--obs-file=": 14, "--obs-trace=": 14,
    "--obs-rotate-mb=": 14, "--obs-blackbox=": 14, "--profile-dir=": 14,
}

_UNPORTED_MODES = {"model": 10, "pipeline": 10}

#: reduced-precision storage the serving options take (None: the compute
#: dtype, which keeps every exact-parity guarantee)
SERVE_DTYPES = ("bf16", "int8")


def serve_dtype_error(kv_dtype, weight_dtype, paged: bool) -> str | None:
    """Why ``--kv-dtype``/``--weight-dtype`` cannot be served (the engine
    constructors' rules, at parse time with the flag's name), or None.
    Both CLIs report it: the training CLI exits, the serving CLI errors."""
    for flag, v in (("--kv-dtype", kv_dtype),
                    ("--weight-dtype", weight_dtype)):
        if v is not None and v not in SERVE_DTYPES:
            return (f"unknown {flag} {v!r}; choose from "
                    f"{'/'.join(SERVE_DTYPES)} (or leave unset for full "
                    "precision)")
    if kv_dtype == "int8" and not paged:
        return ("--kv-dtype int8 requires --paged: int8 KV stores "
                "per-position scales alongside the block pools; the v1 "
                "slot table supports bf16 only (the spec-decode draft "
                "pool inherits --kv-dtype automatically)")
    return None


def _dest(flag: str) -> str:
    return "unported_" + flag.strip("-=").replace("-", "_")


def build_parser(workload: str = "") -> argparse.ArgumentParser:
    """The JAX CLI's flags: those of this slice with their defaults, and
    the refused ones (default None, so only a flag that is given counts)."""
    wd = WORKLOAD_DEFAULTS.get(workload.lower(), WORKLOAD_DEFAULTS["mlp"])
    p = argparse.ArgumentParser(
        prog=workload or "ddl-torch",
        description="PyTorch/CUDA port of the distributed deep learning "
                    "trainer")
    p.add_argument("-l", "--nlayers", type=int, default=wd["nlayers"],
                   help="number of hidden/dense/LSTM layers")
    p.add_argument("-s", "--size", type=int, default=wd["size"],
                   help="hidden size / bottleneck size")
    p.add_argument("-e", "--epochs", type=int, default=10)
    p.add_argument("-b", "--batch", type=int, default=32,
                   help="global batch size")
    p.add_argument("-d", "--device", choices=["cuda", "gpu", "cpu"],
                   default="cuda",
                   help="cuda (gpu is an alias) or cpu; cuda without a "
                        "card raises")
    # -w and -p are accepted as the JAX CLI accepts them; a run on token
    # data reads neither
    p.add_argument("-w", "--nworkers", type=int, default=0)
    p.add_argument("-m", "--mode", choices=[m.value for m in Mode],
                   default="sequential")
    p.add_argument("-p", "--pipeline", type=int, default=2,
                   help="pipeline microbatch size (ignored unless -m "
                        "pipeline)")
    p.add_argument("-r", "--run", type=int, default=1,
                   help="ranks of a -m data run: with --spawn, this many "
                        "local processes; without, a launcher's environment "
                        "must say so")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--dtype", choices=["float32", "bfloat16"],
                   default="float32")
    p.add_argument("--dropout", type=float, default=0.0,
                   help="dropout rate (masks from a generator seeded with "
                        "seed + 1; 0 = deterministic)")
    p.add_argument("--data-dir", type=str, default=None,
                   help="directory holding tokens.npy (gpt); synthetic "
                        "data without it")
    p.add_argument("--attention", choices=["auto", "dense", "flash"],
                   default="auto",
                   help="auto = the flash kernels on cuda, dense on cpu; "
                        "flash on cpu runs the kernels' plain versions")
    p.add_argument("--window", dest="attention_window", type=int,
                   default=None, metavar="W",
                   help="sliding-window attention: each position attends "
                        "its last W tokens")
    p.add_argument("--optimizer",
                   choices=["auto", "sgd", "momentum", "adam", "adamw",
                            "adafactor", "lamb"],
                   default="auto")
    p.add_argument("--label-smoothing", type=float, default=0.0,
                   metavar="EPS")
    p.add_argument("--kv-heads", dest="num_kv_heads", type=int,
                   default=None, metavar="K")
    p.add_argument("--pos", dest="pos_embedding",
                   choices=["learned", "rope"], default="learned")
    p.add_argument("--schedule", dest="lr_schedule",
                   choices=["none", "cosine", "rsqrt", "step"],
                   default="none")
    p.add_argument("--warmup", dest="warmup_steps", type=int, default=None)
    p.add_argument("--clip-norm", type=float, default=None)
    p.add_argument("--no-sync", dest="sync", action="store_false",
                   help="replicate reference quirk Q1 (-m data trains "
                        "independent replicas; rank 0's 1/N shard is "
                        "logged)")
    p.add_argument("--remat", action="store_true",
                   help="recompute each layer in the backward "
                        "(torch.utils.checkpoint)")
    p.add_argument("--remat-policy", dest="remat_policy", default="nothing",
                   choices=REMAT_POLICIES,
                   help="with --remat: what the backward may keep; "
                        "'nothing' recomputes all, 'dots'/'dots_no_batch' "
                        "keep matmul outputs")
    p.add_argument("--grad-accum", type=int, default=1,
                   help="split each batch into this many sequential "
                        "microbatches, accumulating gradients")
    p.add_argument("--checkpoint-dir", type=str, default=None)
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="also checkpoint every N train steps (0 = per "
                        "epoch only); resume replays the loader to the "
                        "exact batch")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--generate", dest="generate_tokens", type=int,
                   default=0, metavar="N",
                   help="gpt: after training, print N-token greedy "
                        "continuations of two dataset prompts (KV-cached "
                        "decode)")
    p.add_argument("--serve", action="store_true",
                   help="gpt: after training, serve a seeded mixed-length "
                        "trace through the slot engine (or --paged) and "
                        "log tokens/s, occupancy and decode captures")
    p.add_argument("--max-slots", dest="max_slots", type=int, default=8,
                   metavar="S", help="serving: concurrent decode slots")
    p.add_argument("--prefill-buckets", dest="prefill_buckets", type=str,
                   default=None, metavar="L1,L2,...",
                   help="accepted and checked as the JAX CLI's, so its "
                        "command lines parse; the port prefills at the "
                        "true prompt length and has no buckets")
    p.add_argument("--paged", action="store_true",
                   help="serving: the paged-KV engine (prefix reuse, "
                        "chunked prefill, the paged flash-decode kernel)")
    p.add_argument("--kv-block-size", dest="kv_block_size", type=int,
                   default=16, metavar="B",
                   help="paged serving: tokens per KV block")
    p.add_argument("--prefill-chunk", dest="prefill_chunk", type=int,
                   default=32, metavar="C",
                   help="paged serving: prefill slice width")
    p.add_argument("--draft", type=int, default=0, metavar="N",
                   help="paged serving: speculative decoding with a draft "
                        "built from the target's first N layers (shared "
                        "weights; greedy outputs unchanged); 0 disables")
    p.add_argument("--spec-k", dest="spec_k", type=int, default=4,
                   metavar="K",
                   help="paged serving: draft tokens proposed a round "
                        "(verified in one batched target forward)")
    p.add_argument("--slo-ttft-ms", dest="slo_ttft_ms", type=float,
                   default=None, metavar="MS",
                   help="serving: per-request time-to-first-token SLO")
    p.add_argument("--slo-e2e-ms", dest="slo_e2e_ms", type=float,
                   default=None, metavar="MS",
                   help="serving: per-request end-to-end latency SLO")
    p.add_argument("--kv-dtype", dest="kv_dtype", type=str, default=None,
                   metavar="DT",
                   help="serving: KV-cache storage dtype, bf16 or int8 "
                        "(int8 keeps per-position scales in the block "
                        "pools: requires --paged; the draft's pools "
                        "inherit it; unset = the compute dtype)")
    p.add_argument("--weight-dtype", dest="weight_dtype", type=str,
                   default=None, metavar="DT",
                   help="serving: weight storage dtype, bf16 or int8 "
                        "(per-output-channel scales, each weight "
                        "dequantized at its use; unset = full precision)")
    for flag, item in UNPORTED_FLAGS.items():
        kw = ({"type": str, "metavar": "X"} if flag.endswith("=")
              else {"action": "store_true", "default": None})
        p.add_argument(flag.rstrip("="), dest=_dest(flag),
                       help=f"not ported yet ({ROADMAP_ITEMS[item]})", **kw)
    return p


def parse_args(argv: Sequence[str] | None = None,
               workload: str = "") -> Config:
    args = build_parser(workload).parse_args(argv)
    # the JAX CLI's parse-time checks (utils/config.py:932-943 there)
    if args.checkpoint_every and not args.checkpoint_dir:
        raise SystemExit("--checkpoint-every requires --checkpoint-dir "
                         "(silently dropping the cadence would be worse "
                         "than an error)")
    if args.checkpoint_every < 0:
        raise SystemExit(f"--checkpoint-every {args.checkpoint_every}: "
                         "must be >= 0")
    if args.remat_policy != "nothing" and not args.remat:
        raise SystemExit("--remat-policy requires --remat (a policy "
                         "without rematerialisation would be a silent "
                         "no-op)")
    # the JAX CLI's serving checks (utils/config.py:1012-1020, 1029-1033)
    if args.max_slots <= 0:
        raise SystemExit(f"--max-slots {args.max_slots}: must be >= 1 "
                         "(the engine's static batch dimension)")
    if args.kv_block_size < 1:
        raise SystemExit(f"--kv-block-size {args.kv_block_size}: must "
                         "be >= 1")
    if args.prefill_chunk < 1:
        raise SystemExit(f"--prefill-chunk {args.prefill_chunk}: must "
                         "be >= 1")
    if args.draft < 0:
        raise SystemExit(f"--draft {args.draft}: must be >= 0 (0 turns "
                         "speculative decoding off)")
    if args.draft and not args.paged:
        raise SystemExit("--draft requires --paged (speculation runs "
                         "inside the paged engine)")
    if args.spec_k < 1:
        raise SystemExit(f"--spec-k {args.spec_k}: must be >= 1")
    for flag, v in (("--slo-ttft-ms", args.slo_ttft_ms),
                    ("--slo-e2e-ms", args.slo_e2e_ms)):
        if v is not None and v <= 0:
            raise SystemExit(f"{flag} {v}: must be positive milliseconds")
    err = serve_dtype_error(args.kv_dtype, args.weight_dtype, args.paged)
    if err:
        raise SystemExit(err)
    for flag, item in UNPORTED_FLAGS.items():
        if getattr(args, _dest(flag)) is not None:
            raise NotImplementedError(
                f"{flag.rstrip('=')} is not ported yet: {ROADMAP_ITEMS[item]}")
    if args.mode in _UNPORTED_MODES:
        raise NotImplementedError(
            f"-m {args.mode} is not ported yet: "
            f"{ROADMAP_ITEMS[_UNPORTED_MODES[args.mode]]}")
    return Config(
        num_layers=args.nlayers, size=args.size, epochs=args.epochs,
        batch_size=args.batch,
        device="cuda" if args.device == "gpu" else args.device,
        mode=Mode(args.mode), seed=args.seed,
        learning_rate=args.lr, dtype=args.dtype, dropout=args.dropout,
        data_dir=args.data_dir, attention=args.attention,
        attention_window=args.attention_window, optimizer=args.optimizer,
        pos_embedding=args.pos_embedding, num_kv_heads=args.num_kv_heads,
        label_smoothing=args.label_smoothing, lr_schedule=args.lr_schedule,
        warmup_steps=args.warmup_steps, clip_norm=args.clip_norm,
        world_size=args.run, sync_in_local_data_mode=args.sync,
        remat=args.remat, remat_policy=args.remat_policy,
        grad_accum=args.grad_accum, checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every, resume=args.resume,
        generate_tokens=args.generate_tokens, serve=args.serve,
        max_slots=args.max_slots,
        prefill_buckets=parse_buckets_arg(args.prefill_buckets),
        paged=args.paged, kv_block_size=args.kv_block_size,
        prefill_chunk=args.prefill_chunk, draft=args.draft,
        spec_k=args.spec_k, slo_ttft_ms=args.slo_ttft_ms,
        slo_e2e_ms=args.slo_e2e_ms, kv_dtype=args.kv_dtype,
        weight_dtype=args.weight_dtype)


def parse_buckets_arg(text: str | None) -> tuple[int, ...] | None:
    """``--prefill-buckets`` string -> ascending lengths, validated at
    parse time (a copy of the JAX CLI's)."""
    if not text:
        return None
    try:
        buckets = tuple(int(b) for b in text.split(","))
    except ValueError:
        raise SystemExit(f"--prefill-buckets {text!r}: expected "
                         "comma-separated integers") from None
    if any(b < 1 for b in buckets):
        raise SystemExit(f"--prefill-buckets {text!r}: lengths must be "
                         ">= 1")
    for a, b in zip(buckets, buckets[1:]):
        if b == a:
            raise SystemExit(f"--prefill-buckets {text!r}: duplicate "
                             f"bucket {a}")
        if b < a:
            raise SystemExit(f"--prefill-buckets {text!r}: lengths must "
                             f"be strictly ascending, got {b} after {a}")
    return buckets
