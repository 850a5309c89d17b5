"""Microbench of the quantized and ring-overlapped FSDP collectives: the
counterpart of ``scripts/comm_bench.py``, over ranks of the port's
:mod:`..parallel.collectives`.

Measures the three claims the collectives make, on ``--ranks`` ranks (2
by default) of one process group:

* **wire bytes**: the analytic bytes a step of the explicit FSDP dataflow
  sends (parameter all-gather + gradient reduce-scatter) under each wire
  format, and the int8/bf16 reduction against f32 (JAX's numbers exactly:
  :func:`..parallel.collectives.fsdp_wire_stats` over JAX's leaf rule);
* **numerics**: the ring collectives on integer-valued blocks, whose sums
  are exact, so the ring's reduction order must be bit-equal to the plain
  collective's (the exactness gate), and the bf16/int8 wire formats'
  relative errors;
* **overlap**: the wall time of the fused ring :func:`gather_matmul` (hop
  k+1 in flight during matmul k) against the same product after a whole
  all-gather; the fraction of the gather's time the ring hides, recorded
  through :class:`..obs.timeline.Timeline` spans and a
  ``comm_overlap_fraction`` gauge.  Over gloo on one card every hop is
  staged through pinned host memory (``collectives.host_staged``), so the
  fraction measures that staging, not a wire: the record says so
  (``overlap.host_staged``);
* **parity**: the explicit FSDP step (:class:`ExplicitFSDP`) with
  ``method="none"`` against FSDP2 (``parallel.zero.apply_fsdp``, the
  port's annotation path) on the same model, optimizer and batch, plus
  the int8 + error-feedback step's loss drift against it.

    python -m distributed_deep_learning_tpu_torch.scripts.comm_bench
    python -m distributed_deep_learning_tpu_torch.scripts.comm_bench \\
        --device cpu --ranks 2

The ranks are launched through :func:`..runtime.launch.launch_local` (on
the card: one card a rank, refused otherwise); under a torchrun
environment (``WORLD_SIZE`` set) the script runs as the rank it is given,
in the process group it finds or makes.  Rank 0 prints the record (JAX's
keys, plus ``device``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time


#: seconds the launched ranks may take
RANK_TIMEOUT = 600.0


def _timed(fn, device, *, steps: int, reps: int = 3) -> float:
    """Best-of-``reps`` mean seconds a call after one warm call, waiting
    for the card; every rank makes the same calls."""
    import torch

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    fn()
    sync()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        sync()
        best = min(best, (time.perf_counter() - t0) / steps)
    return best


def run(device="cuda", rows: int = 512, cols: int = 2048, inner: int = 256,
        steps: int = 5, parity_steps: int = 3, registry=None) -> dict:
    """The collectives record (see the module docstring) over the default
    process group; every rank calls it, every rank returns it (the
    timings are each rank's own).  ``registry`` (an
    ``obs.metrics.MetricsRegistry``) receives the ``comm_bytes{op,method}``
    counters and the overlap gauge."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from distributed_deep_learning_tpu_torch.data.loader import local_rows
    from distributed_deep_learning_tpu_torch.models.mlp import MLP
    from distributed_deep_learning_tpu_torch.obs.timeline import Timeline
    from distributed_deep_learning_tpu_torch.parallel import \
        collectives as coll
    from distributed_deep_learning_tpu_torch.parallel.zero import apply_fsdp
    from distributed_deep_learning_tpu_torch.runtime.mesh import (MeshLayout,
                                                                  build_mesh)
    from distributed_deep_learning_tpu_torch.train.objectives import RowMean
    from distributed_deep_learning_tpu_torch.train.state import (
        Optimizer, create_train_state)
    from distributed_deep_learning_tpu_torch.train.step import make_step_fns

    device = torch.device(device)
    S, rank = dist.get_world_size(), dist.get_rank()
    if S < 2:
        raise RuntimeError("comm_bench needs >= 2 ranks to shard anything "
                           "(--ranks N, or a torchrun environment)")
    world = dist.group.WORLD
    rng = np.random.default_rng(7)

    def agree(value: float, op) -> float:
        t = torch.tensor([float(value)], dtype=torch.float64)
        dist.all_reduce(t, op=op)
        return float(t[0])

    # ---- wire bytes: the explicit FSDP dataflow on an MLP's parameters --
    geom = MLP(64, hidden_size=256, num_hidden_layers=2, num_classes=8)
    layouts = coll.flax_layouts(geom)
    shapes = [tuple(layouts(n)[0](torch.empty(p.shape, device="meta")).shape)
              for n, p in geom.named_parameters()]
    dims = [coll.shard_dim(s, S, min_leaf_size=16) for s in shapes]
    bytes_rec: dict = {}
    for method in coll.METHODS:
        st = coll.fsdp_wire_stats(shapes, dims, S, method)
        key = "fp32" if method == "none" else method
        bytes_rec[key] = {
            "all_gather": st["all_gather_bytes"],
            "reduce_scatter": st["reduce_scatter_bytes"],
        }
        if registry is not None and method != "none":
            registry.counter("comm_bytes", op="all_gather",
                             method=method).inc(st["all_gather_bytes"])
            registry.counter("comm_bytes", op="reduce_scatter",
                             method=method).inc(st["reduce_scatter_bytes"])
    total = {k: v["all_gather"] + v["reduce_scatter"]
             for k, v in bytes_rec.items()}
    bytes_rec["int8_reduction_x"] = round(total["fp32"] / total["int8"], 2)
    bytes_rec["bf16_reduction_x"] = round(total["fp32"] / total["bf16"], 2)

    # ---- numerics: the ring collectives against the plain ones ----------
    # integer-valued floats: sums are exact, so the ring's reduction order
    # must give the plain collective's bits
    blk = torch.as_tensor(rng.integers(-8, 9, (S * 4, 32)),
                          dtype=torch.float32).to(device)
    mine = blk[rank * 4:(rank + 1) * 4]

    def gathered(method, overlap):
        return coll.all_gather(mine, world, method=method, overlap=overlap)

    def scattered(method, overlap):
        return coll.reduce_scatter(blk * (1.0 + rank), world, method=method,
                                   overlap=overlap)

    ref_g, ref_s = gathered("none", False), scattered("none", False)
    scale_g = agree(ref_g.abs().max(), dist.ReduceOp.MAX) or 1.0
    scale_s = agree(ref_s.abs().max(), dist.ReduceOp.MAX) or 1.0
    numerics = {
        "ring_all_gather_exact": bool(agree(
            bool(torch.equal(gathered("none", True), ref_g)),
            dist.ReduceOp.MIN)),
        "ring_reduce_scatter_exact": bool(agree(
            bool(torch.equal(scattered("none", True), ref_s)),
            dist.ReduceOp.MIN)),
    }
    for method in ("bf16", "int8"):
        err_g = agree((gathered(method, True) - ref_g).abs().max(),
                      dist.ReduceOp.MAX)
        err_s = agree((scattered(method, True) - ref_s).abs().max(),
                      dist.ReduceOp.MAX)
        numerics[f"{method}_all_gather_rel_err"] = round(err_g / scale_g, 5)
        numerics[f"{method}_reduce_scatter_rel_err"] = round(
            err_s / scale_s, 5)

    # ---- overlap: the fused ring gather_matmul vs gather-then-matmul -----
    a = rng.standard_normal((S * rows, cols)).astype(np.float32)
    b = torch.from_numpy(rng.standard_normal((cols, inner))
                         .astype(np.float32)).to(device)
    a_blk = torch.from_numpy(a[rank * rows:(rank + 1) * rows]).to(device)

    def gather_only():
        return coll.all_gather(a_blk, world)

    def fused(overlap):
        return lambda: coll.gather_matmul(a_blk, b, world, overlap=overlap)

    tl = Timeline()
    with tl.span("comm_gather"):
        t_comm = _timed(gather_only, device, steps=steps)
    full = gather_only()
    with tl.span("comm_matmul"):
        t_mm = _timed(lambda: full @ b, device, steps=steps)
    with tl.span("comm_ring"):
        t_ring = _timed(fused(True), device, steps=steps)
    with tl.span("comm_sequential"):
        t_seq = _timed(fused(False), device, steps=steps)
    # how much of the gather's time the ring schedule hides, against the
    # sequential program (a whole all-gather, then one matmul): the same
    # bytes and FLOPs, only the schedule differs
    fraction = max(0.0, min(1.0, (t_seq - t_ring) / t_comm)) \
        if t_comm > 0 else 0.0
    if registry is not None:
        registry.gauge("comm_overlap_fraction").set(fraction)
    overlap_rec = {
        "gather_seconds": round(t_comm, 6),
        "matmul_seconds": round(t_mm, 6),
        "ring_fused_seconds": round(t_ring, 6),
        "sequential_fused_seconds": round(t_seq, 6),
        "overlap_fraction": round(fraction, 4),
        "timeline_seconds": {k: round(v, 6)
                             for k, v in tl.seconds.items()},
        # gloo stages a CUDA tensor's hops through pinned host memory:
        # then the fraction measures that staging, not a wire
        "host_staged": coll.host_staged(a_blk, world),
    }

    # ---- parity: the explicit FSDP step vs FSDP2 -------------------------
    shape = {"data": 2, "fsdp": S // 2} if S >= 4 and S % 2 == 0 \
        else {"data": 1, "fsdp": S}
    layout = MeshLayout.of(build_mesh(shape, device.type))
    x = rng.standard_normal((16, 32)).astype(np.float32)
    y = np.eye(8, dtype=np.float32)[np.arange(16) % 8]
    own = local_rows(16, layout.batch_rank, layout.batch_world)
    xl, yl = (torch.from_numpy(t[own]).to(device) for t in (x, y))
    tx, loss_fn = Optimizer("adam", 1e-2), RowMean()

    def fresh(explicit, method="none", overlap=False, attach=False):
        st = create_train_state(
            MLP(32, hidden_size=64, num_hidden_layers=2, num_classes=8), 0,
            tx, device=device, shard=None if explicit
            else (lambda m: apply_fsdp(m, layout)))
        if not explicit:
            return st, make_step_fns(loss_fn, global_batch=True,
                                     group=layout.batch_group)[0]
        comm = coll.ExplicitFSDP(st.model, layout, method, overlap,
                                 min_leaf_size=16)
        st.comm = comm
        st.optimizer = tx.build(comm.masters.items(), layout=comm.layout(
            getattr(st.model, "flax_layout", None)))
        if attach:
            coll.attach_residual(st, st.model.named_parameters())
        return st, coll.make_fsdp_step_fns(loss_fn, comm)[0]

    losses = {"annotation": [], "explicit_none": [], "explicit_int8_ef": []}
    for name, args in (("annotation", (False,)),
                       ("explicit_none", (True, "none", False, False)),
                       ("explicit_int8_ef", (True, "int8", True, True))):
        st, step = fresh(*args)
        for _ in range(parity_steps):
            st, m = step(st, xl, yl)
            losses[name].append(float(m["loss"]))
    ref = losses["annotation"]
    parity = {
        "steps": parity_steps,
        "losses": {k: [round(v, 6) for v in vs] for k, vs in losses.items()},
        "explicit_none_max_abs_delta": round(max(
            abs(p - q) for p, q in zip(ref, losses["explicit_none"])), 8),
        "int8_ef_max_abs_delta": round(max(
            abs(p - q) for p, q in zip(ref, losses["explicit_int8_ef"])), 6),
    }

    return {
        "metric": "quantized + ring-overlapped FSDP collectives",
        "n_devices": S,
        "device": str(device),
        "bytes": bytes_rec,
        "numerics": numerics,
        "overlap": overlap_rec,
        "parity": parity,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="microbench the quantized/ring FSDP collectives")
    p.add_argument("--rows", type=int, default=512,
                   help="per-shard block rows for the overlap timing")
    p.add_argument("--cols", type=int, default=2048)
    p.add_argument("--inner", type=int, default=256,
                   help="matmul output width")
    p.add_argument("--steps", type=int, default=5,
                   help="timed iterations per variant")
    p.add_argument("--parity-steps", type=int, default=3,
                   help="train steps for the loss-parity gate")
    p.add_argument("--ranks", type=int, default=2,
                   help="ranks to launch (without a torchrun environment)")
    p.add_argument("--device", default="cuda", help="cuda or cpu")
    p.add_argument("--out", default=None,
                   help="rank 0 also writes the JSON record here")
    args = p.parse_args(argv)

    if "WORLD_SIZE" not in os.environ:
        from distributed_deep_learning_tpu_torch.runtime.launch import \
            launch_local

        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, "record.json")
            rank_argv = list(sys.argv[1:] if argv is None else argv)
            launch_local(args.ranks, [*rank_argv, "--out", out],
                         device=args.device, timeout=RANK_TIMEOUT,
                         module="distributed_deep_learning_tpu_torch."
                                "scripts.comm_bench")
            with open(out) as f:
                rec = json.load(f)
        print(json.dumps(rec, indent=1))
        if args.out:
            with open(args.out, "w") as f:
                f.write(json.dumps(rec) + "\n")
        return 0

    from distributed_deep_learning_tpu_torch.runtime import bootstrap

    env, created = bootstrap.initialize(args.device)
    try:
        rec = run(env.device, rows=args.rows, cols=args.cols,
                  inner=args.inner, steps=args.steps,
                  parity_steps=args.parity_steps)
    finally:
        if created:
            bootstrap.shutdown()
    if env.rank == 0:
        print(json.dumps(rec, indent=1))
        if args.out:
            with open(args.out, "w") as f:
                f.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
