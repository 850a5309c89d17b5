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

from distributed_deep_learning_tpu_torch.models.transformer import \
    remat_call

StageFn = Callable[..., torch.Tensor]


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


def mb_generator(seed: int, stage: int, microbatch: int, device
                 ) -> torch.Generator:
    """The dropout generator of one (virtual stage, microbatch): seeded
    from ``(seed, stage, microbatch)``, the same each time it is made."""
    state = np.random.SeedSequence([seed, stage, microbatch]).generate_state(
        2, np.uint32)
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


def _execute(ops, n_virtual, stage_fn, head_loss_fn, stacked, index_of,
             head_params, xs, ts, has_aux, seed, stats):
    """Walk ``ops`` (``(tick, virtual stage, 'F'|'B', microbatch)``, in
    tick order) on one controller; see the module docstring."""
    M, L = xs.shape[0], n_virtual
    device = xs.device
    fwd_in, bwd_ct, resid = {}, {}, {}
    live, peak = [0] * L, [0] * L
    tg = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
          for k, p in stacked.items()}
    hg = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
          for k, p in head_params.items()}
    loss = torch.zeros((), dtype=torch.float32, device=device)
    aux, dxs = None, [None] * M
    detached = {k: p.detach() for k, p in stacked.items()}
    for _, v, kind, m in ops:
        gen = None if seed is None else mb_generator(seed, v, m, device)
        if kind == "F":
            inp = xs[m] if v == 0 else fwd_in.pop((v, m))
            resid[(v, m)] = inp
            live[v] += 1
            peak[v] = max(peak[v], live[v])
            if v < L - 1:       # the last one's B computes it with the head
                with torch.no_grad():
                    fwd_in[(v + 1, m)] = stage_fn(
                        _slice(detached, index_of(v)), inp, gen)
            continue
        rin = resid.pop((v, m)).detach().requires_grad_()
        live[v] -= 1
        params = {k: p.requires_grad_() for k, p in
                  _slice(detached, index_of(v)).items()}
        with torch.enable_grad():
            y = stage_fn(params, rin, gen)
            names = list(params)
            inputs = [params[k] for k in names] + [rin]
            if v == L - 1:
                hp = {k: p.detach().requires_grad_()
                      for k, p in head_params.items()}
                lval = head_loss_fn(hp, y, ts[m])
                if has_aux:
                    lval, aux_mb = lval
                    aux = aux_mb if aux is None else \
                        {k: aux[k] + aux_mb[k] for k in aux}
                loss = loss + lval.detach().float()
                grads = torch.autograd.grad(lval, inputs + list(hp.values()))
                for k, g in zip(hp, grads[len(inputs):]):
                    hg[k] += g.float()
            else:
                grads = torch.autograd.grad(y, inputs,
                                            grad_outputs=bwd_ct.pop((v, m)))
        index = index_of(v)
        for k, g in zip(names, grads):
            tg[k][index] += g.float()
        dinp = grads[len(names)]
        if v > 0:
            bwd_ct[(v - 1, m)] = dinp
        else:
            dxs[m] = dinp
    if stats is not None:
        stats["peak_live"] = peak
    scale = 1.0 / M
    dx = torch.stack(dxs) * scale
    out = (loss * scale, {k: g * scale for k, g in tg.items()},
           {k: g * scale for k, g in hg.items()},
           dx.reshape(-1, *dx.shape[2:]))
    return (*out, aux) if has_aux else out


def spmd_pipeline_1f1b(stage_fn: StageFn, head_loss_fn, stacked_params: dict,
                       head_params: dict, x, targets, *,
                       microbatch_size: Optional[int] = None,
                       has_aux: bool = False, seed: Optional[int] = None,
                       stats: Optional[dict] = None):
    """One-forward-one-backward pipelined train pass over ``S`` stages
    (the stacked parameters' leading size).

    ``head_loss_fn(head_params, y_mb, target_mb)`` is the head and the
    mean loss of one microbatch (``(loss, aux)`` with ``has_aux``: aux
    entries are summed over microbatches).  Returns ``(loss,
    trunk_grads, head_grads, dx[, aux])``; ``dx`` is the loss's
    cotangent with respect to ``x`` (for the embedding's backward).
    ``stats``, when given, receives each stage's peak of live inputs
    (``peak_live``)."""
    S = next(iter(stacked_params.values())).shape[0]
    xs, ts, M, _ = _split_microbatches(x, targets, microbatch_size, S)
    ops = [(t, s, kind, m) for t, s, kind, m in one_f_one_b_schedule(M, S)]
    return _execute(ops, S, stage_fn, head_loss_fn, stacked_params,
                    lambda v: v, head_params, xs, ts, has_aux, seed, stats)


def spmd_pipeline_interleaved(stage_fn: StageFn, head_loss_fn,
                              stacked_params: dict, head_params: dict, x,
                              targets, *,
                              microbatch_size: Optional[int] = None,
                              has_aux: bool = False,
                              seed: Optional[int] = None,
                              stats: Optional[dict] = None):
    """Interleaved-1F1B pipelined train pass: the stacked parameters lead
    with ``(V, S, ...)``, chunk ``c`` of device ``s`` being virtual stage
    ``c·S + s``, driven by :func:`interleaved_1f1b_schedule`; the contract
    is :func:`spmd_pipeline_1f1b`'s, with the gradients in the ``(V, S,
    ...)`` layout and each virtual stage's dropout generator its own."""
    V, S = next(iter(stacked_params.values())).shape[:2]
    xs, ts, M, _ = _split_microbatches(x, targets, microbatch_size, S)
    sched, _ = interleaved_1f1b_schedule(M, S, V)
    ops = [(t, c * S + s, kind, m) for t, s, kind, c, m in sched]
    ops.sort(key=lambda o: o[0])            # stable: in-tick order kept
    return _execute(ops, V * S, stage_fn, head_loss_fn, stacked_params,
                    lambda v: (v // S, v % S), head_params, xs, ts,
                    has_aux, seed, stats)
