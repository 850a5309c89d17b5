"""Run configuration and the workload CLI: the port of
``distributed_deep_learning_tpu/utils/config.py`` for the flags the port
runs (``mlp``, ``cnn``, ``lstm``, ``mnist``, ``resnet``, ``transformer``,
``bert`` and ``gpt`` under ``-m sequential|model|pipeline|data`` with
``--nstages``, ``--pipeline-schedule`` and ``--virtual-stages``, ``-m
data`` with ``--mesh`` and ``--zero 1|fsdp``, ``--dtype``,
``--double-softmax``, ``--packed-cache``, ``--image-size``,
``--stem-s2d``, every ``--optimizer``, the step variants, checkpointing,
the resilience flags (``--sentinel*``, ``--elastic``, ``--heartbeat-*``),
the post-train ``--generate`` and ``--serve [--paged]`` with
speculation (``--draft``, ``--spec-k``), quantized serving
(``--kv-dtype``, ``--weight-dtype``), supervision and hot reload
(``--serve-deadline-ms``, ``--serve-retries``, ``--reload-watch``,
``--canary-slots``, ``--admission``, ``--publish-weights``) and the
fleet (``--replicas``, ``--priority-classes``, ``--spill-dir``,
``--migrate``, ``--evacuate-on``, ``--autoscale``), resharding
(``--reshard``, ``--target-mesh``) and tuning (``--autotune``,
``--plan``)).

Flag names, defaults, parse-time checks and the per-workload ``-l/-s``
defaults are the JAX CLI's, except ``-d``: ``cuda`` (the default; ``gpu``
is an alias) or ``cpu``.  ``--spawn`` is taken off the command line by
``__main__`` before parsing, as in the JAX package.  A JAX CLI flag the
port does not run yet would be accepted by the parser only to be refused
(:data:`UNPORTED_FLAGS`: :func:`parse_args` raises
``NotImplementedError`` naming its ``ROADMAP.md`` item); none is left.
"""

from __future__ import annotations

import argparse
import dataclasses
import enum
import os
from typing import Sequence

#: ``--remat-policy`` names, as the JAX CLI's; the models map each to the
#: products their backward keeps (``models.layers.REMAT_SAVED_OPS``)
REMAT_POLICIES = ("nothing", "dots", "dots_no_batch")


class Mode(str, enum.Enum):
    """Execution mode, 1:1 with the reference CLI (``-m``)."""

    SEQUENTIAL = "sequential"
    MODEL = "model"
    PIPELINE = "pipeline"
    DATA = "data"

    def __str__(self) -> str:
        return self.value


#: the canonical mesh axes, outermost first (the JAX package's
#: ``MESH_AXES``): ``--mesh`` names a size for any of them
MESH_AXES = ("data", "fsdp", "stage", "model", "seq", "expert")


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
    double_softmax: bool = False        # mlp, cnn: quirk Q4's head softmax
    num_workers: int = 0                # -w: image-decode threads (cnn,
                                        #   resnet's ImageFolder)
    packed_cache: str | None = None     # a packed sample cache to train on
    image_size: int = 224               # resnet: --data-dir decode size
    stem_s2d: bool = False              # resnet: space-to-depth stem
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
    microbatch: int | None = 2          # -p: pipeline microbatch SIZE
                                        #   (the reference's; -m pipeline)
    num_stages: int | None = None       # --nstages: model/pipeline stages
    pipeline_schedule: str = "gpipe"    # gpipe | 1f1b | interleaved
    virtual_stages: int = 2             # chunks a stage (interleaved)
    sync_in_local_data_mode: bool = True  # False: --no-sync (quirk Q1)
    mesh_shape: dict | None = None      # --mesh: axis -> size (-m data)
    zero: str = "none"                  # --zero: none | 1 | fsdp
    grad_compress: str = "none"         # -m data's gradient all-reduce
                                        #   wire format: none|bf16|int8
    comm: str = "none"                  # --zero fsdp's explicit
                                        #   collectives: none|bf16|int8
    comm_overlap: bool = False          # those collectives as rings
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
    sentinel: str = "off"               # anomaly sentinel policy:
                                        #   off|skip|rollback|halt
    sentinel_window: int = 32           # its running means' horizon
    sentinel_factor: float = 10.0       # its spike threshold (x the mean)
    elastic: bool = False               # checkpointed restart on failure
    heartbeat_dir: str | None = None    # shared dir for liveness beats
    heartbeat_timeout: float = 30.0     # seconds before a peer is dead
    weight_dtype: str | None = None     # serving: weight storage, bf16 or
                                        #   int8 (per-channel scales)
    serve_deadline_ms: float | None = None  # supervised serving: hard
                                        #   per-request wall deadline
    serve_retries: int = 2              # supervised serving: engine-fault
                                        #   replays a request may survive
    reload_watch: str | None = None     # supervised serving: hot weight-
                                        #   reload watch directory
    canary_slots: int = 2               # supervised serving: slots routed
                                        #   to candidate weights
    admission: dict | None = None       # supervised serving: admission-
                                        #   control knobs (--admission)
    replicas: int = 1                   # fleet serving: paged-engine
                                        #   replicas behind the router
    priority_classes: tuple | None = None  # fleet serving: priority mix
    spill_dir: str | None = None        # fleet serving: npz audit of
                                        #   preempted-slot KV
    autoscale: dict | None = None       # fleet serving: elastic replica-
                                        #   count knobs (--autoscale)
    evacuate_on: str = "off"            # fleet serving: live mid-request
                                        #   slot evacuation trigger
    migrate: str = "host"               # serving: where preempted KV
                                        #   parks (host | device)
    publish_weights: str | None = None  # checkpointing: publish each save
                                        #   for --reload-watch
    disagg: bool = False                # serving: prefill and decode pools
                                        #   joined by KV-block migration
    pool_elastic: bool = False          # disagg serving: move a worker
                                        #   between the pools on skew
    prefill_workers: int = 1            # disagg serving: prefill workers
    profile_dir: str | None = None      # torch.profiler trace of each fit
    metrics_file: str | None = None     # JSONL event sink (rank 0)
    obs: bool = False                   # run telemetry (obs/)
    obs_file: str | None = None         # its sidecar (obs_events.jsonl)
    obs_trace: str | None = None        # span-trace export (Chrome JSON)
    obs_rotate_mb: float | None = None  # size-cap the sidecar
    obs_blackbox: str | None = None     # arm the flight recorder
    reshard: bool = False               # cross-topology resume: restore a
                                        #   checkpoint saved on another
                                        #   layout, re-planning (reshard/)
    target_mesh: dict[str, int] | None = None  # --target-mesh: pin the
                                        #   restart mesh instead
    autotune: bool = False              # search the plan lattice (tune/)
                                        #   before training, train under
                                        #   the best measured plan
    plan_file: str | None = None        # plan artifact: --plan applies it;
                                        #   with --autotune the search
                                        #   result is written there

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
ROADMAP_ITEMS: dict = {}

#: JAX CLI flags the port refuses -> the item that ports them; a
#: trailing "=" marks a flag that takes a value (none is left)
UNPORTED_FLAGS: dict = {}

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


def local_device_count(device: str) -> int:
    """Devices a ``-d`` choice sees: the visible CUDA devices, or the one
    CPU (what the JAX CLI's ``len(jax.local_devices())`` counts)."""
    if device == "cpu":
        return 1
    import torch

    return torch.cuda.device_count()


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
    # -w: the image-decode threads of cnn and of resnet's ImageFolder
    p.add_argument("-w", "--nworkers", type=int, default=0)
    p.add_argument("-m", "--mode", choices=[m.value for m in Mode],
                   default="sequential")
    p.add_argument("-p", "--pipeline", type=int, default=2,
                   help="pipeline microbatch size (the reference's -p: a "
                        "size, not a count; ignored unless -m pipeline)")
    p.add_argument("--nstages", type=int, default=None,
                   help="number of model/pipeline stages (default: the "
                        "visible devices; stage i on device i mod n)")
    p.add_argument("--pipeline-schedule",
                   choices=["gpipe", "1f1b", "interleaved"],
                   default="gpipe",
                   help="pipeline schedule (-m pipeline, transformer/bert/"
                        "gpt): gpipe = fill-drain, autograd's backward; "
                        "1f1b = one-forward-one-backward with O(stages) "
                        "activation residency; interleaved = 1f1b with "
                        "--virtual-stages model chunks per stage")
    p.add_argument("--virtual-stages", type=int, default=2,
                   help="model chunks per stage for --pipeline-schedule "
                        "interleaved (layers must divide nstages x this)")
    p.add_argument("-r", "--run", type=int, default=1,
                   help="ranks of a -m data run: with --spawn, this many "
                        "local processes; without, a launcher's environment "
                        "must say so")
    p.add_argument("--mesh", type=str, default=None,
                   help="-m data: explicit mesh over the ranks, e.g. "
                        "'data=2,model=2' (axes data, fsdp, model, expert; "
                        "their product is the world size)")
    p.add_argument("--zero", choices=["none", "1", "fsdp"], default="none",
                   help="shard optimizer state (ZeRO-1) or params+optimizer "
                        "(fsdp) over the fsdp/data mesh axes")
    p.add_argument("--grad-compress", choices=["none", "bf16", "int8"],
                   default="none",
                   help="compress the data-parallel gradient all-reduce: "
                        "bf16 halves wire bytes; int8 is common-scale "
                        "quantization with int32 reduction and an "
                        "error-feedback residual")
    p.add_argument("--comm", choices=["none", "bf16", "int8"],
                   default="none",
                   help="with --zero fsdp: the explicit param all-gather / "
                        "grad reduce-scatter, quantized on the wire (int8: "
                        "per-leaf scale, error-feedback residuals; "
                        "parallel/collectives.py)")
    p.add_argument("--comm-overlap", action="store_true",
                   help="with --comm: run those collectives as "
                        "double-buffered send/recv rings")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--dtype", choices=["float32", "bfloat16"],
                   default="float32")
    p.add_argument("--double-softmax", action="store_true",
                   help="mlp/cnn: replicate reference quirk Q4 (a softmax "
                        "head feeding the cross-entropy)")
    p.add_argument("--dropout", type=float, default=0.0,
                   help="dropout rate (masks from a generator seeded with "
                        "seed + 1; 0 = deterministic)")
    p.add_argument("--data-dir", type=str, default=None,
                   help="the workload's real data (gpt: tokens.npy; mlp, "
                        "lstm: dataset.csv; cnn: the PCB tree; mnist: "
                        "idx or .npy files); synthetic data without it")
    p.add_argument("--packed-cache", type=str, default=None, metavar="FILE",
                   help="train from a packed pre-decoded sample cache "
                        "(data.packed.pack_dataset's artifact, byte-"
                        "compatible with the JAX package's): memory-mapped, "
                        "one slab gather a batch")
    p.add_argument("--image-size", type=int, default=224,
                   help="resnet: square decode size for --data-dir images")
    p.add_argument("--stem-s2d", action="store_true",
                   help="resnet: space-to-depth stem (2x2 input patches "
                        "packed into channels, the equivalent masked 4x4 "
                        "stride-1 stem conv; ImageNet-size stems only)")
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
    p.add_argument("--sentinel", choices=["off", "skip", "rollback", "halt"],
                   default="off",
                   help="anomaly sentinel: detect non-finite loss/grads "
                        "and grad-norm/loss spikes in the train step and "
                        "contain the update before it reaches the "
                        "parameters: 'skip' drops the bad batch and "
                        "continues, 'rollback' restores the last "
                        "checkpoint with the bad step skipped (needs "
                        "--elastic), 'halt' stops the run with clean state")
    p.add_argument("--sentinel-window", type=int, default=32, metavar="N",
                   help="sentinel horizon in steps for the running "
                        "grad-norm/loss means spike detection compares "
                        "against")
    p.add_argument("--sentinel-factor", type=float, default=10.0,
                   metavar="X",
                   help="sentinel spike threshold: a step whose grad norm "
                        "or loss exceeds X times its running mean is "
                        "anomalous")
    p.add_argument("--elastic", action="store_true",
                   help="restart from the last checkpoint on worker failure "
                        "or runtime error (requires --checkpoint-dir)")
    p.add_argument("--heartbeat-dir", type=str, default=None,
                   help="shared directory for liveness heartbeats; with "
                        "--elastic, dead peers abort the step promptly "
                        "instead of hanging the collective")
    p.add_argument("--reshard", action="store_true",
                   help="cross-topology resume: restore the checkpoint even "
                        "if it was saved on a different mesh, re-planning "
                        "for the surviving devices via tune/ (requires "
                        "--resume or --elastic)")
    p.add_argument("--target-mesh", type=str, default=None, metavar="SHAPE",
                   help="with --reshard: restore onto exactly this mesh "
                        "(same axis=N syntax as --mesh) instead of "
                        "re-planning")
    p.add_argument("--heartbeat-timeout", type=float, default=30.0)
    p.add_argument("--autotune", action="store_true",
                   help="search the mesh x microbatch x remat x ZeRO plan "
                        "lattice (tune/) with memory-model pruning and "
                        "measured trials, write the winning plan artifact "
                        "(--plan sets the path), then train under it")
    p.add_argument("--plan", dest="plan_file", type=str, default=None,
                   metavar="FILE",
                   help="apply a plan artifact from a previous --autotune "
                        "run (rejected if its key does not match this "
                        "workload/geometry/topology); with --autotune, "
                        "where to write the search result")
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
    p.add_argument("--serve-deadline-ms", dest="serve_deadline_ms",
                   type=float, default=None, metavar="MS",
                   help="supervised serving: hard per-request wall "
                        "deadline — a request a fault loop holds past "
                        "this errors out instead of replaying forever "
                        "(serve/supervisor.py; implies supervision)")
    p.add_argument("--serve-retries", dest="serve_retries", type=int,
                   default=2, metavar="N",
                   help="supervised serving: engine faults a request may "
                        "survive (with zero-loss replay) before it is "
                        "errored out")
    p.add_argument("--reload-watch", dest="reload_watch", type=str,
                   default=None, metavar="DIR",
                   help="supervised serving: watch DIR for atomically "
                        "published weights (serve/reload.py) and hot-swap "
                        "them between ticks — canary first, integrity-"
                        "manifest verified, corrupt saves quarantined")
    p.add_argument("--canary-slots", dest="canary_slots", type=int,
                   default=2, metavar="N",
                   help="supervised serving: decode slots routed to "
                        "candidate weights while old/new agreement and "
                        "logprob drift decide promote vs rollback "
                        "(0 = swap verified weights directly)")
    p.add_argument("--admission", type=str, default=None,
                   metavar="K=V,...",
                   help="supervised serving: SLO-aware admission control "
                        "— 'depth=16,itl-p99-ms=200,shed-priority=2' "
                        "(keys: depth, itl-p99-ms, shed-priority, "
                        "patience, cool); degrades quality (spec decode "
                        "off, chunk budget down) before shedding, and "
                        "never sheds priority-0 requests")
    p.add_argument("--replicas", type=int, default=1, metavar="N",
                   help="fleet serving: run N paged-engine replicas "
                        "behind the health-checked prefix-affinity "
                        "router (serve/fleet.py) — crash-quarantine with "
                        "zero-loss cross-replica replay; requires "
                        "--paged when N > 1")
    p.add_argument("--priority-classes", dest="priority_classes",
                   type=str, default=None, metavar="P=F,...",
                   help="fleet serving: request priority mix, e.g. "
                        "'0=0.25,1=0.5,2=0.25' (priority=fraction, "
                        "fractions sum to 1); under slot/block pressure "
                        "higher-priority arrivals preempt the lowest-"
                        "priority slots (KV spilled to host, resumed "
                        "bit-identically); priority 0 is never "
                        "preempted or shed; requires --paged")
    p.add_argument("--spill-dir", dest="spill_dir", type=str,
                   default=None, metavar="DIR",
                   help="fleet serving: also write each preempted "
                        "slot's spilled KV to DIR as an npz audit "
                        "trail (resume itself stays in host memory); "
                        "requires --priority-classes")
    p.add_argument("--autoscale", type=str, default=None,
                   metavar="K=V,...",
                   help="fleet serving: elastic replica autoscaling, "
                        "e.g. 'min=1,max=4,patience=2,cool=2' — "
                        "patience consecutive hot rounds warm one new "
                        "replica from the published weights (prefix-"
                        "warmed via clone_prefix), cool consecutive "
                        "cold rounds retire one through the drain "
                        "protocol (stop placement, evacuate open "
                        "slots, retire); requires --replicas > 1")
    p.add_argument("--evacuate-on", dest="evacuate_on",
                   choices=["off", "degraded", "hotspot"],
                   default="off",
                   help="fleet serving: live mid-request slot "
                        "evacuation — on 'degraded' a health-degraded "
                        "replica's open slots migrate (digest-verified "
                        "committed KV) to healthy peers and resume "
                        "bit-identically; 'hotspot' also evacuates on "
                        "sustained per-replica latency skew; requires "
                        "--replicas > 1")
    p.add_argument("--migrate", choices=["host", "device"],
                   default="host",
                   help="serving preemption: where a preempted slot's "
                        "KV parks — host (pinned memory, npz-auditable, "
                        "the default) or device (a tensor on the card, "
                        "its digest checked on resume)")
    p.add_argument("--publish-weights", dest="publish_weights", type=str,
                   default=None, metavar="DIR",
                   help="checkpointing: after each verified save, "
                        "atomically publish the params to DIR in the "
                        "serve/reload.py manifest format, so serving "
                        "fleets watching it (--reload-watch) hot-swap "
                        "the new weights; requires --checkpoint-dir")
    p.add_argument("--disagg", action="store_true",
                   help="serving: disaggregate the replica into a "
                        "prefill worker pool and decode workers joined "
                        "by KV-block migration (serve/disagg.py); "
                        "requires --paged and at least 2 devices")
    p.add_argument("--prefill-workers", dest="prefill_workers", type=int,
                   default=1, metavar="N",
                   help="disaggregated serving: devices in the prefill "
                        "pool; the remaining visible devices decode "
                        "(requires --disagg)")
    p.add_argument("--pool-elastic", dest="pool_elastic",
                   action="store_true",
                   help="disaggregated serving: after the run, judge the "
                        "measured prefill_util against the pool "
                        "rebalancer's hysteresis and reassign one idle "
                        "worker between the pools when the skew is "
                        "sustained (requires --disagg)")
    p.add_argument("--profile-dir", type=str, default=None,
                   help="write a torch.profiler trace of each fit here "
                        "(the card's activity only, as Chrome JSON)")
    p.add_argument("--metrics-file", type=str, default=None,
                   help="append one JSON object per phase/metric event "
                        "(structured sibling of the reference log stream)")
    p.add_argument("--obs", action="store_true",
                   help="run telemetry (obs/): per-step spans rolled up "
                        "into a goodput breakdown, MFU from the step's "
                        "counted FLOPs and the card's peak, and a JSONL "
                        "event stream")
    p.add_argument("--obs-file", type=str, default=None, metavar="PATH",
                   help="telemetry event-stream path (default "
                        "obs_events.jsonl; requires --obs)")
    p.add_argument("--obs-trace", type=str, default=None, metavar="PATH",
                   help="also record causal spans and export them here as "
                        "Chrome/Perfetto trace JSON (requires --obs)")
    p.add_argument("--obs-rotate-mb", type=float, default=None,
                   metavar="MB",
                   help="rotate the JSONL sidecar at this many MB, "
                        "fsyncing each closed segment (requires --obs)")
    p.add_argument("--obs-blackbox", type=str, default=None,
                   metavar="PATH",
                   help="arm a crash flight recorder, dumped here on a "
                        "sentinel anomaly, an SLO breach, a fatal signal "
                        "or exit (requires --obs)")
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
    # the JAX CLI's resilience checks (utils/config.py:943-951 there),
    # after its --remat-policy check
    if args.sentinel == "rollback" and not args.elastic:
        raise SystemExit("--sentinel rollback requires --elastic (rollback "
                         "restores the last checkpoint and replays with "
                         "the bad step skipped — that machinery IS the "
                         "elastic restart loop)")
    if args.sentinel != "off" and (args.sentinel_window < 1
                                   or args.sentinel_factor <= 1.0):
        raise SystemExit("--sentinel-window must be >= 1 and "
                         "--sentinel-factor > 1")
    # the JAX CLI's resharding checks (utils/config.py:952-962 there)
    if args.reshard and not (args.resume or args.elastic):
        raise SystemExit("--reshard requires --resume or --elastic (it "
                         "changes how an existing checkpoint is restored; "
                         "a fresh run has nothing to reshard)")
    if args.reshard and not args.checkpoint_dir:
        raise SystemExit("--reshard requires --checkpoint-dir (the "
                         "topology manifest lives next to the checkpoint)")
    if args.target_mesh and not args.reshard:
        raise SystemExit("--target-mesh requires --reshard (without the "
                         "resharding restore a mesh change would restore "
                         "garbage; use --mesh to shape a fresh run)")
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
                    ("--slo-e2e-ms", args.slo_e2e_ms),
                    ("--serve-deadline-ms", args.serve_deadline_ms)):
        if v is not None and v <= 0:
            raise SystemExit(f"{flag} {v}: must be positive milliseconds")
    # the JAX CLI's supervision and fleet checks (utils/config.py:1034-
    # 1133 there), in its order and with its messages; the disaggregated
    # flags' checks come with disaggregation, refused below
    if args.serve_retries < 0:
        raise SystemExit(f"--serve-retries {args.serve_retries}: must be "
                         ">= 0 (0 = error a request on its first engine "
                         "fault)")
    if args.canary_slots < 0:
        raise SystemExit(f"--canary-slots {args.canary_slots}: must be "
                         ">= 0 (0 swaps verified weights without a "
                         "canary)")
    # the cap only binds when a reload watch will actually canary: the
    # default canary_slots must not invalidate small --max-slots runs
    if args.reload_watch and args.canary_slots >= args.max_slots:
        raise SystemExit(f"--canary-slots {args.canary_slots}: must be "
                         f"< --max-slots {args.max_slots} (at least one "
                         "slot must keep serving the stable weights)")
    for flag, v in (("--reload-watch", args.reload_watch),
                    ("--admission", args.admission)):
        if v and not args.serve:
            raise SystemExit(f"{flag} requires --serve (it extends the "
                             "post-train serving demo)")
    err = serve_dtype_error(args.kv_dtype, args.weight_dtype, args.paged)
    if err:
        raise SystemExit(err)
    if args.replicas < 1:
        raise SystemExit(f"--replicas {args.replicas}: must be >= 1 "
                         "(1 = a single un-routed engine)")
    if args.replicas > 1 and not args.paged:
        raise SystemExit("--replicas > 1 requires --paged (the fleet "
                         "router's prefix-affinity placement and "
                         "zero-loss failover replay are built on the "
                         "paged engine's prefix index and ledger)")
    # the rebalance tier (evacuation + autoscaling) lives in the fleet
    # router: both flags are meaningless without a routed replica set
    if args.autoscale and args.replicas < 2:
        raise SystemExit("--autoscale requires --replicas > 1 (elastic "
                         "sizing grows/shrinks the fleet router's "
                         "replica set; a single un-routed engine has "
                         "nothing to scale)")
    if args.evacuate_on != "off" and args.replicas < 2:
        raise SystemExit(f"--evacuate-on {args.evacuate_on} requires "
                         "--replicas > 1 (a mid-request evacuation "
                         "needs a healthy peer to migrate the open "
                         "slots' committed KV to)")
    if args.priority_classes and not args.paged:
        raise SystemExit("--priority-classes requires --paged "
                         "(priority preemption spills and resumes "
                         "paged KV blocks)")
    if args.spill_dir and not args.priority_classes:
        raise SystemExit("--spill-dir requires --priority-classes "
                         "(spill files are only written when "
                         "preemption can fire)")
    if args.disagg and not args.paged:
        raise SystemExit("--disagg requires --paged (the prefill and "
                         "decode pools exchange committed paged-KV "
                         "blocks; the dense slot cache has no block "
                         "table to migrate)")
    if args.prefill_workers < 1:
        raise SystemExit(f"--prefill-workers {args.prefill_workers}: "
                         "must be >= 1")
    if args.prefill_workers != 1 and not args.disagg:
        raise SystemExit("--prefill-workers requires --disagg (worker "
                         "pools only exist in disaggregated serving)")
    if args.pool_elastic and not args.disagg:
        raise SystemExit("--pool-elastic requires --disagg (role "
                         "reassignment moves a worker between the "
                         "prefill and decode pools, which only exist "
                         "in disaggregated serving)")
    if args.disagg:
        # the JAX CLI resolves the visible devices here, so the flag's
        # name is in the refusal
        ndev = local_device_count(args.device)
        if ndev < 2:
            raise SystemExit("--disagg: disaggregated serving needs "
                             ">= 2 local devices (one per pool); only "
                             f"{ndev} visible — drop --disagg for the "
                             "unified paged engine, or run under a "
                             "multi-device mesh")
        if args.prefill_workers >= ndev:
            raise SystemExit(f"--prefill-workers {args.prefill_workers}"
                             f": the {ndev} visible devices must "
                             "partition into prefill + decode pools "
                             "with at least one decode worker — use "
                             f"1..{ndev - 1}")
    if args.publish_weights and not args.checkpoint_dir:
        raise SystemExit("--publish-weights requires --checkpoint-dir "
                         "(only verified checkpoint saves are "
                         "published for serving reload)")
    # the JAX CLI's mesh checks (utils/config.py:964-968 there)
    mesh_shape = parse_mesh_arg(args.mesh)
    if mesh_shape and args.nstages and \
            mesh_shape.get("stage", args.nstages) != args.nstages:
        raise SystemExit(f"--mesh stage={mesh_shape['stage']} conflicts "
                         f"with --nstages {args.nstages}; drop one (--mesh "
                         "wins over the mode-derived stage count)")
    # the JAX CLI's --comm checks (utils/config.py:969-996 there)
    if args.comm != "none":
        if args.zero != "fsdp":
            raise SystemExit("--comm quantizes the explicit FSDP param "
                             "all-gather / grad reduce-scatter; it requires "
                             "--zero fsdp (with no sharded params there is "
                             "no such collective to compress)")
        if args.grad_compress != "none":
            raise SystemExit("--comm and --grad-compress are mutually "
                             "exclusive: the FSDP dataflow has no pure "
                             "gradient all-reduce for --grad-compress to "
                             "act on")
        if args.grad_accum > 1:
            raise SystemExit("--comm does not compose with --grad-accum "
                             "(the accumulation loop re-gathers params per "
                             "microstep; quantizing those repeats is not "
                             "implemented)")
        bad = [a for a in ("model", "expert", "stage", "seq")
               if (mesh_shape or {}).get(a, 0) > 1]
        if bad:
            raise SystemExit(f"--comm requires a data/fsdp-only mesh; got "
                             f"{'/'.join(bad)} axes (the explicit FSDP "
                             "step owns the whole dataflow and does not "
                             "compose with model/expert/stage/seq "
                             "sharding)")
    if args.comm_overlap and args.comm == "none":
        raise SystemExit("--comm-overlap requires --comm bf16|int8 (it "
                         "selects the ring schedule for the explicit "
                         "collectives --comm turns on)")
    if args.plan_file and not args.autotune and \
            not os.path.exists(args.plan_file):
        raise SystemExit(f"--plan {args.plan_file}: no such file (run "
                         "--autotune to produce one)")
    # the JAX CLI's --obs checks (utils/config.py:1000-1011 there)
    if args.obs_file and not args.obs:
        raise SystemExit("--obs-file requires --obs (the path names the "
                         "telemetry stream --obs records)")
    for flag, val in (("--obs-trace", args.obs_trace),
                      ("--obs-rotate-mb", args.obs_rotate_mb),
                      ("--obs-blackbox", args.obs_blackbox)):
        if val and not args.obs:
            raise SystemExit(f"{flag} requires --obs (it extends the "
                             "telemetry --obs turns on)")
    if args.obs_rotate_mb is not None and args.obs_rotate_mb <= 0:
        raise SystemExit(f"--obs-rotate-mb {args.obs_rotate_mb}: must "
                         "be > 0")
    for flag, item in UNPORTED_FLAGS.items():
        if getattr(args, _dest(flag)) is not None:
            raise NotImplementedError(
                f"{flag.rstrip('=')} is not ported yet: {ROADMAP_ITEMS[item]}")
    if (mesh_shape or {}).get("seq", 1) != 1:
        # the JAX runner builds a seq axis and leaves it idle under -m
        # data; ring attention and Ulysses are library entry points
        raise NotImplementedError(
            "--mesh seq=: no CLI path runs context parallelism (the JAX "
            "runner builds the axis and leaves it idle under -m data); "
            "ring attention and Ulysses are library entry points, "
            "parallel.ring_attention and parallel.ulysses")
    return Config(
        num_layers=args.nlayers, size=args.size, epochs=args.epochs,
        batch_size=args.batch,
        device="cuda" if args.device == "gpu" else args.device,
        mode=Mode(args.mode), seed=args.seed,
        learning_rate=args.lr, dtype=args.dtype,
        double_softmax=args.double_softmax, num_workers=args.nworkers,
        packed_cache=args.packed_cache, image_size=args.image_size,
        stem_s2d=args.stem_s2d,
        dropout=args.dropout,
        data_dir=args.data_dir, attention=args.attention,
        attention_window=args.attention_window, optimizer=args.optimizer,
        pos_embedding=args.pos_embedding, num_kv_heads=args.num_kv_heads,
        label_smoothing=args.label_smoothing, lr_schedule=args.lr_schedule,
        warmup_steps=args.warmup_steps, clip_norm=args.clip_norm,
        world_size=args.run, sync_in_local_data_mode=args.sync,
        mesh_shape=mesh_shape, zero=args.zero,
        grad_compress=args.grad_compress, comm=args.comm,
        comm_overlap=args.comm_overlap,
        microbatch=args.pipeline, num_stages=args.nstages,
        pipeline_schedule=args.pipeline_schedule,
        virtual_stages=args.virtual_stages,
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
        weight_dtype=args.weight_dtype, sentinel=args.sentinel,
        sentinel_window=args.sentinel_window,
        sentinel_factor=args.sentinel_factor, elastic=args.elastic,
        heartbeat_dir=args.heartbeat_dir,
        heartbeat_timeout=args.heartbeat_timeout,
        serve_deadline_ms=args.serve_deadline_ms,
        serve_retries=args.serve_retries, reload_watch=args.reload_watch,
        canary_slots=args.canary_slots,
        admission=parse_admission_arg(args.admission),
        replicas=args.replicas,
        priority_classes=parse_priority_classes(args.priority_classes),
        spill_dir=args.spill_dir,
        autoscale=parse_autoscale_arg(args.autoscale),
        evacuate_on=args.evacuate_on, migrate=args.migrate,
        publish_weights=args.publish_weights, disagg=args.disagg,
        pool_elastic=args.pool_elastic,
        prefill_workers=args.prefill_workers, profile_dir=args.profile_dir,
        metrics_file=args.metrics_file, obs=args.obs, obs_file=args.obs_file,
        obs_trace=args.obs_trace, obs_rotate_mb=args.obs_rotate_mb,
        obs_blackbox=args.obs_blackbox, reshard=args.reshard,
        target_mesh=parse_mesh_arg(args.target_mesh, flag="--target-mesh"),
        autotune=args.autotune, plan_file=args.plan_file)


#: ``--admission`` spec keys → (AdmissionController kwarg, converter,
#: minimum).  Kept here so a typo'd knob dies at the CLI boundary with
#: the full key list, not as a TypeError from the controller mid-serve.
_ADMISSION_KEYS = {
    "depth": ("max_queue_depth", int, 1),
    "itl-p99-ms": ("itl_p99_ms", float, 1e-9),
    "shed-priority": ("shed_priority", int, 1),
    "patience": ("patience", int, 1),
    "cool": ("cool", int, 1),
}


def parse_admission_arg(text: str | None,
                        flag: str = "--admission") -> dict | None:
    """``--admission`` string → :class:`..serve.admission.
    AdmissionController` kwargs, validated at parse time (mirrors
    :func:`parse_mesh_arg`).  Example:
    ``"depth=16,itl-p99-ms=200,shed-priority=2"``."""
    if not text:
        return None
    out: dict = {}
    for part in text.split(","):
        key, _, val = part.strip().partition("=")
        if key not in _ADMISSION_KEYS:
            raise SystemExit(
                f"{flag}: unknown key {key!r} in entry {part!r}; known "
                f"keys: {', '.join(sorted(_ADMISSION_KEYS))}")
        name, conv, lo = _ADMISSION_KEYS[key]
        if name in out:
            raise SystemExit(f"{flag}: key {key!r} given twice")
        try:
            v = conv(val)
        except ValueError:
            raise SystemExit(f"{flag}: {key}={val!r} is not a valid "
                             f"{conv.__name__}") from None
        if v < lo:
            raise SystemExit(f"{flag}: {key}={val!r} must be >= {lo}")
        out[name] = v
    return out


#: ``--autoscale`` spec keys → (FleetAutoscaler kwarg, converter,
#: minimum).  Same contract as ``_ADMISSION_KEYS``: a typo'd knob dies
#: at the CLI boundary with the full key list, not as a TypeError from
#: the autoscaler mid-serve.
_AUTOSCALE_KEYS = {
    "min": ("min_replicas", int, 1),
    "max": ("max_replicas", int, 1),
    "patience": ("patience", int, 1),
    "cool": ("cool", int, 1),
}


def parse_autoscale_arg(text: str | None,
                        flag: str = "--autoscale") -> dict | None:
    """``--autoscale`` string → :class:`..serve.autoscaler.
    FleetAutoscaler` kwargs, validated at parse time (mirrors
    :func:`parse_admission_arg`).  Example:
    ``"min=1,max=4,patience=2,cool=2"``."""
    if not text:
        return None
    out: dict = {}
    for part in text.split(","):
        key, _, val = part.strip().partition("=")
        if key not in _AUTOSCALE_KEYS:
            raise SystemExit(
                f"{flag}: unknown key {key!r} in entry {part!r}; known "
                f"keys: {', '.join(sorted(_AUTOSCALE_KEYS))}")
        name, conv, lo = _AUTOSCALE_KEYS[key]
        if name in out:
            raise SystemExit(f"{flag}: key {key!r} given twice")
        try:
            v = conv(val)
        except ValueError:
            raise SystemExit(f"{flag}: {key}={val!r} is not a valid "
                             f"{conv.__name__}") from None
        if v < lo:
            raise SystemExit(f"{flag}: {key}={val!r} must be >= {lo}")
        out[name] = v
    if ("min_replicas" in out and "max_replicas" in out
            and out["max_replicas"] < out["min_replicas"]):
        raise SystemExit(f"{flag}: max={out['max_replicas']} < "
                         f"min={out['min_replicas']} (the fleet cannot "
                         "be smaller than its floor)")
    return out


def parse_priority_classes(text: str | None,
                           flag: str = "--priority-classes"
                           ) -> tuple | None:
    """``--priority-classes`` string → ``LoadSpec.priority_classes``
    tuple, validated at parse time (mirrors :func:`parse_admission_arg`).
    Example: ``"0=0.25,1=0.5,2=0.25"`` → ``((0, 0.25), (1, 0.5),
    (2, 0.25))``."""
    if not text:
        return None
    out: list[tuple[int, float]] = []
    seen: set[int] = set()
    for part in text.split(","):
        key, _, val = part.strip().partition("=")
        if not val:
            raise SystemExit(f"{flag}: bad entry {part!r}; expected "
                             "'<priority>=<fraction>', e.g. '0=0.25'")
        try:
            prio = int(key)
        except ValueError:
            raise SystemExit(f"{flag}: priority {key!r} is not an "
                             "integer") from None
        if prio < 0:
            raise SystemExit(f"{flag}: priority {prio} must be >= 0 "
                             "(0 is the most-protected class)")
        if prio in seen:
            raise SystemExit(f"{flag}: priority {prio} given twice")
        seen.add(prio)
        try:
            frac = float(val)
        except ValueError:
            raise SystemExit(f"{flag}: fraction {val!r} for priority "
                             f"{prio} is not a number") from None
        if frac < 0:
            raise SystemExit(f"{flag}: fraction {frac} for priority "
                             f"{prio} must be >= 0")
        out.append((prio, frac))
    total = sum(f for _, f in out)
    if abs(total - 1.0) > 1e-6:
        raise SystemExit(f"{flag}: fractions must sum to 1, got "
                         f"{total:g}")
    return tuple(out)


def parse_mesh_arg(text: str | None,
                   flag: str = "--mesh") -> dict[str, int] | None:
    """``--mesh`` string -> shape dict, validated at parse time (a copy of
    the JAX CLI's, with its messages).  The device count is checked later
    by ``runtime.mesh.MeshSpec.resolve``, which knows the world size."""
    if not text:
        return None
    shape: dict[str, int] = {}
    for part in text.split(","):
        axis, _, n = part.partition("=")
        axis = axis.strip()
        if not n:
            raise SystemExit(f"{flag}: bad entry {part!r}; expected axis=N "
                             f"with axis one of {', '.join(MESH_AXES)}")
        if axis not in MESH_AXES:
            raise SystemExit(f"{flag}: unknown axis {axis!r}; known axes: "
                             f"{', '.join(MESH_AXES)}")
        if axis in shape:
            raise SystemExit(f"{flag}: axis {axis!r} given twice")
        try:
            size = int(n)
        except ValueError:
            raise SystemExit(f"{flag}: size for axis {axis!r} must be an "
                             f"integer (-1 = fill remaining devices), got "
                             f"{n.strip()!r}") from None
        if size == 0 or size < -1:
            raise SystemExit(f"{flag}: size for axis {axis!r} must be >= 1 "
                             "(or -1 to fill with the remaining devices)")
        shape[axis] = size
    if sum(1 for v in shape.values() if v == -1) > 1:
        raise SystemExit(f"{flag}: at most one axis may be -1")
    return shape


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
