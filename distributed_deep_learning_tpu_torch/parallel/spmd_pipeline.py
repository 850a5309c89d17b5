"""Pipeline schedules over a stacked stage trunk: the port of
``distributed_deep_learning_tpu/parallel/spmd_pipeline.py``.

The JAX package runs these schedules as one XLA program over a ``stage``
mesh axis, activations rotating between devices with ``ppermute``.  The
port is a single controller: the host walks the same tick tables and runs
each tick's stage work in turn, every stage on the one card, where the
stages' parameters are slices of stacked tensors (``(S, ...)``, or ``(V,
S, ...)`` interleaved, as :func:`stack_stage_params` lays them out).  A
stage function is ``stage_fn(params, x, generator=None) -> y`` with
``params`` a dict of one stage's slices and ``y`` shaped as ``x``.

* :func:`spmd_pipeline` (GPipe): at tick ``t`` stage ``s`` runs
  microbatch ``t - s``; autograd keeps every tick's activations, O(M).
* :func:`spmd_pipeline_1f1b` and :func:`spmd_pipeline_interleaved`: the
  forward and the backward hand-scheduled by
  :func:`one_f_one_b_schedule` and :func:`interleaved_1f1b_schedule`
  (copied as they are).  A forward runs without autograd and keeps only
  the stage's input; the backward recomputes the stage from it and takes
  its vector-Jacobian product, so live stage inputs stay O(S) (the
  bound :func:`residency_bound` gives).  The last virtual stage's forward
  only keeps its input: its backward, in the same tick, runs the stage,
  the head and the loss once with autograd, so each block but the last
  virtual stage's runs twice a microbatch.  They return ``(loss,
  trunk_grads, head_grads, dx[, aux])``: the loss is the sum of the
  microbatch means over ``M``, the gradients are f32 and in the stacked
  layout.

Dropout: ``seed`` gives each (virtual stage, microbatch) its own
generator (:func:`mb_generator`); the recompute makes the same one again,
so it replays the forward's masks.  One card holds no data axis here
(``dp = 1``).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from distributed_deep_learning_tpu_torch.models.transformer import \
    remat_call

StageFn = Callable[..., torch.Tensor]

#: the metrics a grid pass sums over the ranks (``prediction_metrics``'s
#: counts; the loss is always summed)
AUX_KEYS = ("correct", "count")


def stack_stage_params(params_list: list[dict]) -> dict:
    """Stack per-stage parameter dicts along a new leading stage axis
    (homogeneous stages: the same names and shapes)."""
    return {k: torch.stack([p[k] for p in params_list])
            for k in params_list[0]}


def _split_microbatches(x, targets, microbatch_size, n_stages):
    """``(xs, ts, M, mb)``: ``x`` (and ``targets``, when given) reshaped to
    ``(M, mb, ...)``; without a size, one microbatch a stage where the
    batch divides (the JAX prologue at ``dp = 1``)."""
    B = x.shape[0]
    if microbatch_size is None:
        M = max(m for m in range(1, n_stages + 1) if B % m == 0)
        mb = B // M
    else:
        mb = microbatch_size
        if B % mb:
            raise ValueError(f"batch {B} not divisible by microbatch {mb}")
        M = B // mb
    xs = x.reshape(M, mb, *x.shape[1:])
    ts = None if targets is None else targets.reshape(M, mb,
                                                      *targets.shape[1:])
    return xs, ts, M, mb


def mb_generator(seed: int, stage: int, microbatch: int, device,
                 data: Optional[int] = None) -> torch.Generator:
    """The dropout generator of one (virtual stage, microbatch): seeded
    from ``(seed, stage, microbatch)``, and the data coordinate ``data``
    on a grid with a data axis (JAX folds its index into the key when
    that axis has more than one rank), the same each time it is made."""
    entropy = [seed, stage, microbatch] + ([] if data is None else [data])
    state = np.random.SeedSequence(entropy).generate_state(2, np.uint32)
    return torch.Generator(device=device).manual_seed(
        int(state[0]) << 31 ^ int(state[1]))


def _slice(stacked: dict, index) -> dict:
    return {k: p[index] for k, p in stacked.items()}


def spmd_pipeline(stage_fn: StageFn, stacked_params: dict, x, *,
                  microbatch_size: Optional[int] = None,
                  seed: Optional[int] = None, stage_offset: int = 0,
                  remat: Optional[str] = None):
    """``x`` ``(B, ...)`` through ``S`` pipelined stages (``S`` the
    stacked parameters' leading size), GPipe's fill-drain order.
    ``seed`` switches dropout on (the generator of stage ``stage_offset +
    s`` and each microbatch); ``remat`` recomputes each stage call in the
    backward under that policy (``models.transformer.remat_call``)."""
    S = next(iter(stacked_params.values())).shape[0]
    B = x.shape[0]
    xs, _, M, _ = _split_microbatches(x, None, microbatch_size, S)
    carry, outs = {}, [None] * M
    for t in range(M + S - 1):
        for s in range(S):
            m = t - s
            if not 0 <= m < M:
                continue
            inp = xs[m] if s == 0 else carry.pop((s, m))
            params = _slice(stacked_params, s)
            gen = None if seed is None else \
                mb_generator(seed, stage_offset + s, m, x.device)

            def fn(a, params=params, gen=gen):
                return stage_fn(params, a, gen)
            out = fn(inp) if remat is None else remat_call(fn, inp, remat,
                                                           gen)
            if s == S - 1:
                outs[m] = out
            else:
                carry[(s + 1, m)] = out
    return torch.stack(outs).reshape(B, *outs[0].shape[1:])


def one_f_one_b_schedule(n_microbatches: int, n_stages: int
                         ) -> list[tuple[int, int, str, int]]:
    """The 1F1B tick table: ``(tick, stage, 'F'|'B', microbatch)`` entries.

    Stage ``s`` forwards microbatch ``m`` at tick ``m + s`` and backwards it
    at tick ``2(S-1) - s + m`` — the backward of microbatch m starts on the
    last stage in the SAME tick as its forward there, then walks left.
    Microbatch m's input on stage s lives for ``2(S-1-s)`` ticks, so peak
    residency is O(S) instead of O(M).
    """
    M, S = n_microbatches, n_stages
    ops = []
    for t in range(M + 2 * S - 2):
        for s in range(S):
            if 0 <= t - s < M:
                ops.append((t, s, "F", t - s))
            if 0 <= t - (2 * S - 2 - s) < M:
                ops.append((t, s, "B", t - (2 * S - 2 - s)))
    return ops


def interleaved_1f1b_schedule(n_microbatches: int, n_stages: int,
                              n_chunks: int, max_in_flight: int = 2):
    """Greedy list schedule for INTERLEAVED 1F1B: ``V`` model chunks per
    device, virtual stage ``v·S + s`` living on device ``s`` (consecutive
    virtual stages on consecutive devices, so activations always hop to
    the ring neighbour).  Cuts the pipeline bubble ~``V``× vs plain 1F1B.

    Returns ``(ops, n_ticks)`` where ops is a list of
    ``(tick, stage, 'F'|'B', chunk, microbatch)``.  Constraints enforced:

    * deps — F(v,m) needs F(v−1,m) at an earlier tick; B(v,m) needs
      B(v+1,m) earlier and F(v,m) at the same tick or earlier (the last
      virtual stage seeds its backward in the same tick, 1F1B style).
    * flow control — at most 2 activations (cotangents) in flight per
      receiving virtual stage.
    * capacity — each device runs ≤ 1 F and ≤ 1 B per tick.

    Priorities: backward first (drains residuals, keeps memory O(S·V)),
    then the deepest ready forward.
    """
    M, S, V = n_microbatches, n_stages, n_chunks
    L = V * S
    f_done: dict[tuple[int, int], int] = {}   # (v, m) -> tick
    b_done: dict[tuple[int, int], int] = {}
    f_count = [0] * L                         # Fs completed per v
    b_count = [0] * L
    ops = []
    t = 0
    while len(b_done) < L * M:
        progressed = False
        for s in range(S):
            hosted = [v for v in range(s, L, S)]
            # ---- backward: smallest microbatch first ----
            b_ready = []
            for v in hosted:
                m = b_count[v]
                if m >= M:
                    continue
                if (v, m) not in f_done or f_done[(v, m)] > t:
                    continue
                if v < L - 1 and b_done.get((v + 1, m), t) >= t:
                    continue
                # sender-side flow control for the cotangent to v-1
                if v > 0 and b_count[v] - b_count[v - 1] >= max_in_flight:
                    continue
                b_ready.append((m, v))
            if b_ready:
                m, v = min(b_ready)
                b_done[(v, m)] = t
                b_count[v] += 1
                ops.append((t, s, "B", v // S, m))
                progressed = True
            # ---- forward: deepest virtual stage first ----
            f_ready = []
            for v in hosted:
                m = f_count[v]
                if m >= M:
                    continue
                if v > 0 and f_done.get((v - 1, m), t) >= t:
                    continue
                # sender-side flow control for the activation to v+1
                if v < L - 1 and f_count[v] - f_count[v + 1] >= max_in_flight:
                    continue
                f_ready.append((-v, m))
            if f_ready:
                negv, m = min(f_ready)
                v = -negv
                f_done[(v, m)] = t
                f_count[v] += 1
                ops.append((t, s, "F", v // S, m))
                progressed = True
                # the last virtual stage may backward the same microbatch
                # in the same tick (seeded by the in-tick head loss), under
                # the same cotangent flow-control bound as the B path
                if v == L - 1 and b_count[v] == m and \
                        (v == 0 or
                         b_count[v] - b_count[v - 1] < max_in_flight) and \
                        (s, t) not in {(o[1], o[0]) for o in ops
                                       if o[2] == "B"}:
                    b_done[(v, m)] = t
                    b_count[v] += 1
                    ops.append((t, s, "B", v // S, m))
        if not progressed and len(b_done) < L * M:
            raise RuntimeError(
                f"interleaved schedule deadlocked at tick {t} "
                f"(M={M}, S={S}, V={V})")
        t += 1
    return ops, t


def residency_bound(M: int, S: int, V: int = 1) -> int:
    """The most stage inputs a virtual stage keeps at once: ``2S - 1``
    under 1F1B (the JAX executor's ring), and under the interleaved
    schedule the most forwarded-but-not-yet-backwarded microbatches of
    any virtual stage, a tick's F counted before its B (the JAX
    executor's ring depth, ``_schedule_tables``)."""
    if V == 1:
        return 2 * S - 1
    ops, _ = interleaved_1f1b_schedule(M, S, V)
    depth, live = 1, {}
    for _, s, kind, c, _ in sorted(ops, key=lambda o: (o[0], o[2] != "F")):
        v = c * S + s
        live[v] = live.get(v, 0) + (1 if kind == "F" else -1)
        depth = max(depth, live[v])
    return depth


class _Walk:
    """One train pass's stage work and its accumulators: the forwards
    and recompute-and-backwards of the virtual stages it is asked to run
    (all of them on one controller, a rank's own on the grid).  ``data``
    (the grid's data coordinate, None at ``dp = 1``) joins each dropout
    generator's seed."""

    def __init__(self, n_virtual, stage_fn, head_loss_fn, stacked,
                 index_of, head_params, xs, ts, has_aux, seed, data=None):
        self.L, self.M = n_virtual, xs.shape[0]
        self.stage_fn, self.head_loss_fn = stage_fn, head_loss_fn
        self.index_of, self.head_params = index_of, head_params
        self.xs, self.ts, self.has_aux = xs, ts, has_aux
        self.seed, self.data = seed, data
        self.fwd_in, self.bwd_ct, self.resid = {}, {}, {}
        self.live, self.peak = [0] * n_virtual, [0] * n_virtual
        self.tg = {k: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
                   for k, p in stacked.items()}
        self.hg = {k: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
                   for k, p in head_params.items()}
        self.loss = torch.zeros((), dtype=torch.float32, device=xs.device)
        self.aux, self.dxs = None, [None] * self.M
        self.detached = {k: p.detach() for k, p in stacked.items()}

    def _gen(self, v, m):
        return None if self.seed is None else \
            mb_generator(self.seed, v, m, self.xs.device, self.data)

    def forward(self, v: int, m: int):
        """Stage ``v``'s forward of microbatch ``m``: its input kept, its
        output returned (None for the last virtual stage, whose backward
        runs it with the head)."""
        inp = self.xs[m] if v == 0 else self.fwd_in.pop((v, m))
        self.resid[(v, m)] = inp
        self.live[v] += 1
        self.peak[v] = max(self.peak[v], self.live[v])
        if v == self.L - 1:
            return None
        with torch.no_grad():
            return self.stage_fn(_slice(self.detached, self.index_of(v)),
                                 inp, self._gen(v, m))

    def backward(self, v: int, m: int):
        """Stage ``v``'s recompute and vector-Jacobian product for
        microbatch ``m`` (the head and the loss too on the last one);
        returns the input's cotangent."""
        rin = self.resid.pop((v, m)).detach().requires_grad_()
        self.live[v] -= 1
        params = {k: p.requires_grad_() for k, p in
                  _slice(self.detached, self.index_of(v)).items()}
        with torch.enable_grad():
            y = self.stage_fn(params, rin, self._gen(v, m))
            names = list(params)
            inputs = [params[k] for k in names] + [rin]
            if v == self.L - 1:
                hp = {k: p.detach().requires_grad_()
                      for k, p in self.head_params.items()}
                lval = self.head_loss_fn(hp, y, self.ts[m])
                if self.has_aux:
                    lval, aux_mb = lval
                    self.aux = aux_mb if self.aux is None else \
                        {k: self.aux[k] + aux_mb[k] for k in self.aux}
                self.loss = self.loss + lval.detach().float()
                grads = torch.autograd.grad(lval,
                                            inputs + list(hp.values()))
                for k, g in zip(hp, grads[len(inputs):]):
                    self.hg[k] += g.float()
            else:
                grads = torch.autograd.grad(
                    y, inputs, grad_outputs=self.bwd_ct.pop((v, m)))
        index = self.index_of(v)
        for k, g in zip(names, grads):
            self.tg[k][index] += g.float()
        dinp = grads[len(names)]
        if v == 0:
            self.dxs[m] = dinp
        return dinp


def _execute(ops, n_virtual, stage_fn, head_loss_fn, stacked, index_of,
             head_params, xs, ts, has_aux, seed, stats):
    """Walk ``ops`` (``(tick, virtual stage, 'F'|'B', microbatch)``, in
    tick order) on one controller; see the module docstring."""
    w = _Walk(n_virtual, stage_fn, head_loss_fn, stacked, index_of,
              head_params, xs, ts, has_aux, seed)
    for _, v, kind, m in ops:
        if kind == "F":
            out = w.forward(v, m)
            if out is not None:
                w.fwd_in[(v + 1, m)] = out
        else:
            dinp = w.backward(v, m)
            if v > 0:
                w.bwd_ct[(v - 1, m)] = dinp
    if stats is not None:
        stats["peak_live"] = w.peak
    scale = 1.0 / w.M
    dx = torch.stack(w.dxs) * scale
    out = (w.loss * scale, {k: g * scale for k, g in w.tg.items()},
           {k: g * scale for k, g in w.hg.items()},
           dx.reshape(-1, *dx.shape[2:]))
    return (*out, w.aux) if has_aux else out


# ---------------------------------------------------------------------------
# the data x stage grid: one rank a stage, send/recv at the boundaries
# ---------------------------------------------------------------------------

#: the tags of a boundary's two directions (two neighbours may be one
#: rank: two stages, or the interleaved wrap S-1 -> 0)
TAG_ACTIVATION, TAG_COTANGENT = 0, 1

#: bytes this process has sent across stage boundaries (activations and
#: their gradients), a counter for measurements to read and reset
sent_bytes = 0


def _exchange(grid, recvs: list, sends: list, like: torch.Tensor) -> dict:
    """One tick's boundary traffic of this rank: ``recvs`` ``(stage, tag,
    key)`` and ``sends`` ``(stage, tag, tensor)`` with this data
    coordinate's stage ranks, every message shaped as ``like``.  The
    receives are posted before the sends, each list in ``(stage, tag)``
    order, so both neighbours post one tick's operations in one order.
    On a gloo group a tensor on a card crosses through pinned host memory
    (:func:`.collectives.host_staged`).  Returns ``{key: tensor}``."""
    from distributed_deep_learning_tpu_torch.parallel.collectives import (
        _pinned, host_staged)

    global sent_bytes
    if not recvs and not sends:
        return {}
    staged = host_staged(like, None)
    ops, bufs, keep = [], {}, []
    for stage, tag, key in sorted(recvs, key=lambda r: r[:2]):
        buf = _pinned(like) if staged else torch.empty_like(like)
        bufs[key] = buf
        ops.append(dist.P2POp(dist.irecv, buf,
                              grid.rank_of(grid.data, stage), tag=tag))
    for stage, tag, t in sorted(sends, key=lambda r: r[:2]):
        t = t.detach().contiguous()
        if staged:
            t = _pinned(t).copy_(t)
        keep.append(t)                  # alive until the transfer ends
        sent_bytes += t.numel() * t.element_size()
        ops.append(dist.P2POp(dist.isend, t,
                              grid.rank_of(grid.data, stage), tag=tag))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return {k: b.to(like.device) if staged else b for k, b in bufs.items()}


def _by_tick(ops) -> list[list]:
    """``ops`` (``(tick, ...)``, in tick order) grouped by tick."""
    ticks: dict = {}
    for op in ops:
        ticks.setdefault(op[0], []).append(op[1:])
    return [ticks[t] for t in sorted(ticks)]


def _grid_execute(ops, n_virtual, stage_fn, head_loss_fn, stacked,
                  index_of, head_params, xs, ts, has_aux, seed, stats,
                  grid):
    """Walk ``ops`` (as :func:`_execute`) as rank ``(d, s)`` of ``grid``:
    at each tick run this rank's own ops (virtual stage ``v`` lives on
    stage ``v mod S``), then exchange the boundary tensors: a forward's
    output to the next virtual stage's rank (the interleaved schedule
    wraps ``S-1 -> 0``), a backward's input cotangent to the previous
    one's.  Then JAX's sums: the loss and ``aux`` over every rank, the
    trunk gradients over the data group, the head's over every rank, all
    scaled by ``1 / (M·dp)``; ``dx`` is stage 0's, None elsewhere."""
    S, me = grid.stages, grid.stage
    w = _Walk(n_virtual, stage_fn, head_loss_fn, stacked, index_of,
              head_params, xs, ts, has_aux, seed,
              data=grid.data if grid.dp > 1 else None)
    L = n_virtual
    for tick in _by_tick(ops):
        recvs, sends = [], []
        for v, kind, m in tick:
            if kind == "F":
                if v % S == me:
                    out = w.forward(v, m)
                    if out is not None:
                        if (v + 1) % S == me:
                            w.fwd_in[(v + 1, m)] = out
                        else:
                            sends.append(((v + 1) % S, TAG_ACTIVATION, out))
                elif v < L - 1 and (v + 1) % S == me:
                    recvs.append((v % S, TAG_ACTIVATION, ("F", v + 1, m)))
            else:
                if v % S == me:
                    dinp = w.backward(v, m)
                    if v > 0:
                        if (v - 1) % S == me:
                            w.bwd_ct[(v - 1, m)] = dinp
                        else:
                            sends.append(((v - 1) % S, TAG_COTANGENT, dinp))
                elif v > 0 and (v - 1) % S == me:
                    recvs.append((v % S, TAG_COTANGENT, ("B", v - 1, m)))
        for (kind, v, m), t in _exchange(grid, recvs, sends,
                                         xs[0]).items():
            (w.fwd_in if kind == "F" else w.bwd_ct)[(v, m)] = t
    if stats is not None:
        stats["peak_live"] = w.peak
    scale = 1.0 / (w.M * grid.dp)
    loss, aux = _grid_sums(w.loss, w.aux or {}, AUX_KEYS if has_aux else (),
                           xs.device)
    tg = _data_summed(w.tg, grid)
    hg = _all_reduced(w.hg)
    for g in (*tg.values(), *hg.values()):
        g.mul_(scale)
    dx = None
    if grid.first:
        dx = torch.stack(w.dxs) * scale
        dx = dx.reshape(-1, *dx.shape[2:])
    out = ((loss * scale).float(), tg, hg, dx)
    return (*out, aux) if has_aux else out


def _grid_sums(loss, aux: dict, keys, device):
    """``(loss, {key: count})`` summed over every rank of the grid (the
    last stage's ranks hold them; the others add zeros), in one f64
    all-reduce; the counts as int32."""
    sums = torch.stack([loss.double()] + [
        aux[k].double() if k in aux else
        torch.zeros((), dtype=torch.float64, device=device) for k in keys])
    dist.all_reduce(sums)
    return sums[0], {k: sums[i + 1].to(torch.int32)
                     for i, k in enumerate(keys)}


def _data_summed(tg: dict, grid) -> dict:
    """The trunk gradients summed over this stage's data group (in
    place)."""
    if grid.data_group is not None:
        for g in tg.values():
            dist.all_reduce(g, group=grid.data_group)
    return tg


def _all_reduced(tensors: dict) -> dict:
    """``tensors`` summed over every rank, in one all-reduce of their
    flat concatenation (per dtype)."""
    if not tensors:
        return {}
    names = list(tensors)
    flat = torch.cat([tensors[k].reshape(-1) for k in names])
    dist.all_reduce(flat)
    out, i = {}, 0
    for k in names:
        n = tensors[k].numel()
        out[k] = flat[i:i + n].view_as(tensors[k])
        i += n
    return out


def spmd_pipeline_1f1b(stage_fn: StageFn, head_loss_fn, stacked_params: dict,
                       head_params: dict, x, targets, *,
                       microbatch_size: Optional[int] = None,
                       has_aux: bool = False, seed: Optional[int] = None,
                       stats: Optional[dict] = None, grid=None):
    """One-forward-one-backward pipelined train pass over ``S`` stages
    (the stacked parameters' leading size).

    ``head_loss_fn(head_params, y_mb, target_mb)`` is the head and the
    mean loss of one microbatch (``(loss, aux)`` with ``has_aux``: aux
    entries are summed over microbatches).  Returns ``(loss,
    trunk_grads, head_grads, dx[, aux])``; ``dx`` is the loss's
    cotangent with respect to ``x`` (for the embedding's backward).
    ``stats``, when given, receives each stage's peak of live inputs
    (``peak_live``).

    ``grid`` (:class:`..runtime.mesh.PipelineGrid`) runs it as rank
    ``(d, s)`` of a data x stage grid: ``stacked_params`` is then this
    rank's slice ``(1, ...)``, ``x``/``targets`` its data coordinate's
    rows (``microbatch_size`` of them a microbatch), and the results are
    JAX's: the loss and ``aux`` (``AUX_KEYS``) over the whole grid, the
    gradients summed over the data axis, ``dx`` on stage 0 only (see
    :func:`_grid_execute`)."""
    S = grid.stages if grid is not None else \
        next(iter(stacked_params.values())).shape[0]
    xs, ts, M, _ = _split_microbatches(x, targets, microbatch_size, S)
    ops = [(t, s, kind, m) for t, s, kind, m in one_f_one_b_schedule(M, S)]
    if grid is not None:
        return _grid_execute(ops, S, stage_fn, head_loss_fn, stacked_params,
                             lambda v: 0, head_params, xs, ts, has_aux,
                             seed, stats, grid)
    return _execute(ops, S, stage_fn, head_loss_fn, stacked_params,
                    lambda v: v, head_params, xs, ts, has_aux, seed, stats)


def spmd_pipeline_interleaved(stage_fn: StageFn, head_loss_fn,
                              stacked_params: dict, head_params: dict, x,
                              targets, *,
                              microbatch_size: Optional[int] = None,
                              has_aux: bool = False,
                              seed: Optional[int] = None,
                              stats: Optional[dict] = None, grid=None):
    """Interleaved-1F1B pipelined train pass: the stacked parameters lead
    with ``(V, S, ...)``, chunk ``c`` of device ``s`` being virtual stage
    ``c·S + s``, driven by :func:`interleaved_1f1b_schedule`; the contract
    is :func:`spmd_pipeline_1f1b`'s, with the gradients in the ``(V, S,
    ...)`` layout and each virtual stage's dropout generator its own.  On
    a ``grid`` a rank holds ``(V, 1, ...)``: its stage's chunks."""
    V = next(iter(stacked_params.values())).shape[0]
    S = grid.stages if grid is not None else \
        next(iter(stacked_params.values())).shape[1]
    xs, ts, M, _ = _split_microbatches(x, targets, microbatch_size, S)
    sched, _ = interleaved_1f1b_schedule(M, S, V)
    ops = [(t, c * S + s, kind, m) for t, s, kind, c, m in sched]
    ops.sort(key=lambda o: o[0])            # stable: in-tick order kept
    if grid is not None:
        return _grid_execute(ops, V * S, stage_fn, head_loss_fn,
                             stacked_params, lambda v: (v // S, 0),
                             head_params, xs, ts, has_aux, seed, stats,
                             grid)
    return _execute(ops, V * S, stage_fn, head_loss_fn, stacked_params,
                    lambda v: (v // S, v % S), head_params, xs, ts,
                    has_aux, seed, stats)


def _grid_forward(stage_fn, params: dict, xs, grid, seed, remat=None,
                  keep_inputs: bool = False):
    """GPipe's forward as rank ``(d, s)`` of ``grid``: at tick ``t`` stage
    ``s`` runs microbatch ``t - s`` and sends its output to ``s + 1``.
    ``params`` is this stage's slice; returns ``(inputs, outputs)`` per
    microbatch (the inputs marked for their gradient when
    ``keep_inputs``: the train pass's backward reads them)."""
    S, me, M = grid.stages, grid.stage, xs.shape[0]
    data = grid.data if grid.dp > 1 else None
    ins, outs, recv = [None] * M, [None] * M, {}
    for t in range(M + S - 1):
        m, sends, recvs = t - me, [], []
        if 0 <= m < M:
            inp = xs[m] if me == 0 else recv.pop(m)
            if keep_inputs:
                inp = inp.detach().requires_grad_()
            gen = None if seed is None else \
                mb_generator(seed, me, m, xs.device, data)

            def fn(a, gen=gen):
                return stage_fn(params, a, gen)
            out = fn(inp) if remat is None else remat_call(fn, inp, remat,
                                                           gen)
            ins[m], outs[m] = inp, out
            if me < S - 1:
                sends.append((me + 1, TAG_ACTIVATION, out))
        if me > 0 and 0 <= t - (me - 1) < M:
            recvs.append((me - 1, TAG_ACTIVATION, t - (me - 1)))
        recv.update(_exchange(grid, recvs, sends, xs[0]))
    return ins, outs


def spmd_pipeline_gpipe(stage_fn: StageFn, head_loss_fn, stacked_params: dict,
                        head_params: dict, x, targets, *, grid,
                        microbatch_size: Optional[int] = None,
                        has_aux: bool = False, seed: Optional[int] = None,
                        remat: Optional[str] = None):
    """GPipe's train pass as rank ``(d, s)`` of ``grid``: the forward of
    :func:`_grid_forward`, every stage keeping its microbatches' graphs
    (O(M) activations); the last stage runs ``head_loss_fn(head_params,
    y, targets)`` once on its rows' outputs (``y`` the microbatches in
    order), then the backward walks the stages in reverse, each stage
    backpropagating a microbatch's kept output when its cotangent
    arrives.  ``head_loss_fn`` returns this data coordinate's share of
    the objective (the shares sum to it over the data axis; ``(loss,
    aux)`` with ``has_aux``).  Returns :func:`spmd_pipeline_1f1b`'s
    ``(loss, trunk_grads, head_grads, dx[, aux])``, the sums taken over
    the grid (no microbatch scale: the head ran once)."""
    S, me = grid.stages, grid.stage
    xs, ts, M, _ = _split_microbatches(x, targets, microbatch_size, S)
    params = {k: p.detach().requires_grad_()
              for k, p in _slice(stacked_params, 0).items()}
    with torch.enable_grad():
        ins, outs = _grid_forward(stage_fn, params, xs, grid, seed, remat,
                                  keep_inputs=True)
        loss = torch.zeros((), dtype=torch.float64, device=xs.device)
        aux = {}
        hp = {k: p.detach().requires_grad_() for k, p in head_params.items()}
        if grid.last:
            y = torch.cat(outs)
            lval = head_loss_fn(hp, y, ts.reshape(-1, *ts.shape[2:]))
            if has_aux:
                lval, aux = lval
            loss = lval.detach().double()
            lval.backward()
    recv = {}
    for t in range(M + S - 1):          # the backward, last stage first
        m, sends, recvs = M - 1 - (t - (S - 1 - me)), [], []
        if 0 <= m < M:
            if not grid.last:
                torch.autograd.backward(outs[m], grad_tensors=recv.pop(m))
            outs[m] = None
            if me > 0:
                sends.append((me - 1, TAG_COTANGENT, ins[m].grad))
        nxt = M - 1 - (t - (S - 2 - me))
        if me < S - 1 and 0 <= nxt < M:
            recvs.append((me + 1, TAG_COTANGENT, nxt))
        recv.update(_exchange(grid, recvs, sends, xs[0]))
    loss, aux = _grid_sums(loss, aux, AUX_KEYS if has_aux else (),
                           xs.device)
    tg = _data_summed({k: (p.grad.float() if p.grad is not None
                           else torch.zeros(p.shape, device=p.device))
                       .unsqueeze(0) for k, p in params.items()}, grid)
    hg = _all_reduced({k: p.grad.float() if p.grad is not None
                       else torch.zeros(p.shape, device=p.device)
                       for k, p in hp.items()})
    dx = torch.cat([i.grad for i in ins]) if grid.first else None
    out = (loss.float(), tg, hg, dx)
    return (*out, aux) if has_aux else out


@torch.no_grad()
def spmd_pipeline_forward(stage_fn: StageFn, stacked_params: dict, x, *,
                          grid, microbatch_size: Optional[int] = None,
                          n_chunks: int = 1):
    """GPipe's forward without gradients (evaluation) as rank ``(d, s)``
    of ``grid``: the last stage's outputs of its rows, in order; None on
    the other stages.  With ``n_chunks`` chunks a stage (the ``(V, 1,
    ...)`` slices) the forward laps the stages ``V`` times, as
    :meth:`..pipeline_transformer.PipelinedTrunk.apply` does, the last
    stage handing each lap's outputs to stage 0."""
    S = grid.stages
    xs, _, _, _ = _split_microbatches(x, None, microbatch_size, S)
    for c in range(n_chunks):
        params = _slice(stacked_params, 0 if n_chunks == 1 else (c, 0))
        _, outs = _grid_forward(stage_fn, params, xs, grid, None)
        if c == n_chunks - 1:
            break
        if S == 1:
            xs = torch.stack(outs)
            continue
        got = _exchange(grid,
                        [(S - 1, TAG_ACTIVATION, "x")] if grid.first else [],
                        [(0, TAG_ACTIVATION, torch.stack(outs))]
                        if grid.last else [], xs)
        if grid.first:
            xs = got["x"]
    return torch.cat(outs) if grid.last else None
