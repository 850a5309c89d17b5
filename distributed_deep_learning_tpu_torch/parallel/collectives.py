"""Quantized and ring-overlapped explicit collectives for FSDP: the port
of ``distributed_deep_learning_tpu/parallel/collectives.py``.

Three layers, as in the JAX package:

1. **Wire formats**: :func:`all_gather` and :func:`reduce_scatter` with
   an explicit ``method``: ``bf16`` (half the bytes) or common-scale
   symmetric ``int8`` (one scale a leaf from an all-reduce MAX of its
   ``amax``).  ``int8`` carries an error-feedback residual
   (:func:`ef_quantize`): step *t*'s quantization error is added back
   before step *t+1* is quantized.  The int8 reduction is emulated in
   int32 and bf16's in f32, as JAX's ``_ACCUM`` says; the gathers move
   the int8/bf16 values themselves.
2. **Ring overlap**: ``overlap=True`` runs each collective as a ring of
   ``batch_isend_irecv`` hops on the group; the all-gather issues hop
   *r+1* before hop *r*'s block is consumed (:func:`gather_matmul`
   consumes each block with its matmul).
3. **The FSDP step**: :class:`ExplicitFSDP` and :func:`make_fsdp_step_fns`,
   what ``--zero fsdp --comm`` runs in place of FSDP2: each rank keeps
   plain-tensor shards of the leaves that
   :func:`..parallel.zero.leaf_shard_spec` splits, gathers the
   parameters for the forward, reduce-scatters the gradients into its
   shards, and updates only those.

:func:`host_staged` is the one place that decides how a CUDA tensor
reaches a ``gloo`` group's send/recv; see there.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.distributed as dist
from torch import nn

METHODS = ("none", "bf16", "int8")

#: claimed wire bytes an element (what :func:`wire_bytes` counts)
WIRE_ITEMSIZE = {"bf16": 2, "int8": 1}

#: int8 ships one f32 scale a leaf a collective
_SCALE_BYTES = 4

#: the reduction's accumulator a method: int32 keeps int8 sums exact, bf16
#: values add in f32
_ACCUM = {"bf16": torch.float32, "int8": torch.int32}


# --------------------------------------------------------------------------
# transport
# --------------------------------------------------------------------------

def host_staged(tensor: torch.Tensor, group) -> bool:
    """Whether a send/recv of ``tensor`` on ``group`` crosses through
    pinned host memory: on a gloo group, for a tensor on a card.  Gloo
    hands a CUDA pointer to its TCP transport, which fails (``writev``:
    Bad address, torch 2.11 on the H100); its all-reduce, all-gather,
    reduce-scatter and all-to-all copy CUDA tensors through the host
    themselves, so they are called as they are (chip_smoke.py's phase 32
    probes each op).  Decided by the group's backend alone: an NCCL group
    is never staged."""
    return tensor.device.type == "cuda" and \
        dist.get_backend(group) == "gloo"


def _pinned(like: torch.Tensor) -> torch.Tensor:
    return torch.empty(like.shape, dtype=like.dtype, pin_memory=True)


class Hop:
    """One ring hop in flight: ``send`` to the next rank of ``group``,
    the previous rank's tensor received into a new buffer; :meth:`wait`
    returns it."""

    def __init__(self, send: torch.Tensor, group):
        size, me = dist.get_world_size(group), dist.get_rank(group)
        nxt, prv = ((me + 1) % size, (me - 1) % size)
        if group is not None:
            nxt = dist.get_global_rank(group, nxt)
            prv = dist.get_global_rank(group, prv)
        send = send.contiguous()
        self.device = send.device
        self.staged = host_staged(send, group)
        if self.staged:
            send = _pinned(send).copy_(send)   # one copy, ended on return
        self.recv = _pinned(send) if self.staged else torch.empty_like(send)
        self._send = send            # alive until the transfer ends
        self._works = dist.batch_isend_irecv(
            [dist.P2POp(dist.isend, send, nxt, group),
             dist.P2POp(dist.irecv, self.recv, prv, group)])

    def wait(self) -> torch.Tensor:
        for w in self._works:
            w.wait()
        return self.recv.to(self.device) if self.staged else self.recv


# --------------------------------------------------------------------------
# wire formats
# --------------------------------------------------------------------------

def quantize(x: torch.Tensor, method: str, group=None):
    """``x`` -> ``(wire, scale)``.  For int8 the scale is the max-|x|
    over ``group`` (one all-reduce MAX), so every rank dequantizes the
    same; ``group=None`` takes the local amax (JAX's ``axis=None``)."""
    if method == "none":
        return x, None
    if method == "bf16":
        return x.to(torch.bfloat16), None
    if method == "int8":
        amax = x.abs().amax()
        if group is not None:
            dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
        scale = torch.clamp(amax / 127.0, min=1e-30)
        q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
        return q, scale
    raise ValueError(f"unknown comm method {method!r}; choose from "
                     f"{METHODS}")


def dequantize(wire, scale, method: str, dtype):
    if method == "none":
        return wire
    if method == "bf16":
        return wire.to(dtype)
    return wire.to(dtype) * scale


def ef_quantize(x, residual, method: str, group=None):
    """Error-feedback quantization: ``(wire, scale, new_residual)``; the
    residual is added back before quantizing and the new error returned.
    ``residual=None`` (or ``method="none"``) is plain :func:`quantize`."""
    if method == "none" or residual is None:
        wire, scale = quantize(x, method, group)
        return wire, scale, residual
    v = x + residual.to(x.dtype)
    wire, scale = quantize(v, method, group)
    return wire, scale, v - dequantize(wire, scale, method, x.dtype)


# --------------------------------------------------------------------------
# ring variants
# --------------------------------------------------------------------------

def _ring_all_gather(wire: torch.Tensor, group) -> torch.Tensor:
    """Ring all-gather of dim-0 blocks, ``(m, ...)`` -> ``(S*m, ...)``:
    the hop for block *r+1* is issued before block *r* is written."""
    S, my = dist.get_world_size(group), dist.get_rank(group)
    out = wire.new_empty((S,) + tuple(wire.shape))
    out[my] = wire
    hop = Hop(wire, group)
    for r in range(1, S):
        blk = hop.wait()
        if r < S - 1:
            hop = Hop(blk, group)        # hop r+1 in flight...
        out[(my - r) % S] = blk          # ...while hop r lands
    return out.reshape((S * wire.shape[0],) + tuple(wire.shape[1:]))


def _ring_reduce_scatter(contrib: torch.Tensor, group) -> torch.Tensor:
    """Ring reduce-scatter: ``(S*m, ...)`` contributions -> this rank's
    summed ``(m, ...)`` chunk.  The partial sum of chunk *j* starts on
    rank *j+1* and collects every rank's contribution on its way round."""
    S, my = dist.get_world_size(group), dist.get_rank(group)
    blocks = contrib.reshape((S, contrib.shape[0] // S)
                             + tuple(contrib.shape[1:]))
    send = blocks[(my - 1) % S]
    for r in range(1, S):
        send = Hop(send, group).wait() + blocks[(my - 1 - r) % S]
    return send


# --------------------------------------------------------------------------
# the collectives
# --------------------------------------------------------------------------

def _plain_gather(wire: torch.Tensor, group) -> torch.Tensor:
    S = dist.get_world_size(group)
    out = wire.new_empty((S * wire.shape[0],) + tuple(wire.shape[1:]))
    dist.all_gather_into_tensor(out, wire.contiguous(), group=group)
    return out


def all_gather(x, group, *, method: str = "none", overlap: bool = False,
               residual=None):
    """All-gather of dim-0 blocks over ``group`` (None: one rank),
    ``(m, ...)`` -> ``(S*m, ...)``, quantized per ``method`` (a common
    scale, so every rank dequantizes the same values), a ring when
    ``overlap``.  With ``residual`` returns ``(gathered,
    new_residual)``."""
    wire, scale, new_res = ef_quantize(x, residual, method, group)
    if group is None:
        gathered = wire
    elif overlap:
        gathered = _ring_all_gather(wire, group)
    else:
        gathered = _plain_gather(wire, group)
    out = dequantize(gathered, scale, method, x.dtype)
    return out if residual is None else (out, new_res)


def reduce_scatter(x, group, *, method: str = "none", overlap: bool = False,
                   residual=None):
    """Reduce-scatter over ``group``: ``(S*m, ...)`` local contributions
    -> this rank's summed ``(m, ...)`` chunk.  The contribution is
    quantized once (with error feedback when ``residual`` is given) and
    summed in int32/f32.  With ``residual`` returns ``(chunk,
    new_residual)``."""
    wire, scale, new_res = ef_quantize(x, residual, method, group)
    contrib = wire if method == "none" else wire.to(_ACCUM[method])
    if group is None:
        acc = contrib
    elif overlap:
        acc = _ring_reduce_scatter(contrib, group)
    else:
        S = dist.get_world_size(group)
        acc = contrib.new_empty((contrib.shape[0] // S,)
                                + tuple(contrib.shape[1:]))
        dist.reduce_scatter_tensor(acc, contrib.contiguous(), group=group)
    if method == "none":
        out = acc
    elif method == "bf16":
        out = acc.to(x.dtype)
    else:
        out = acc.to(x.dtype) * scale
    return out if residual is None else (out, new_res)


def gather_matmul(a_block, b, group, *, method: str = "none",
                  overlap: bool = False):
    """``all_gather(a) @ b`` with the ring's consumer fused in: ``a_block
    (m, k)`` a rank, ``b (k, n)`` replicated -> ``(S*m, n)``; with
    ``overlap`` each arriving chunk's matmul runs while the next chunk's
    hop is in flight, and the gathered operand is never made."""
    wire, scale = quantize(a_block, method, group)
    if group is None or not overlap:
        full = wire if group is None else _plain_gather(wire, group)
        return dequantize(full, scale, method, a_block.dtype) @ b
    S, my = dist.get_world_size(group), dist.get_rank(group)
    m = wire.shape[0]
    out = b.new_empty((S, m, b.shape[1]))
    hop = Hop(wire, group)
    out[my] = dequantize(wire, scale, method, a_block.dtype) @ b
    for r in range(1, S):
        blk = hop.wait()
        if r < S - 1:
            hop = Hop(blk, group)        # chunk r+1 in flight...
        out[(my - r) % S] = dequantize(blk, scale, method,
                                       a_block.dtype) @ b
    return out.reshape(S * m, b.shape[1])


# --------------------------------------------------------------------------
# analytic wire accounting (JAX's numbers)
# --------------------------------------------------------------------------

def wire_bytes(op: str, method: str, shape, axis_size: int,
               itemsize: int = 4) -> int:
    """Bytes one rank sends for one collective: ``shape`` is the local
    block for ``all_gather`` and the full input for ``reduce_scatter``
    ((S-1)/S of the data either way); ``kv_migrate`` is point to point."""
    elems = int(math.prod(shape)) if shape else 1
    if op == "kv_migrate":
        size = WIRE_ITEMSIZE.get(method, itemsize)
        return elems * size + (_SCALE_BYTES if method == "int8" else 0)
    if op == "reduce_scatter":
        elems //= max(1, axis_size)
    sent = elems * (axis_size - 1)
    size = WIRE_ITEMSIZE.get(method, itemsize)
    return sent * size + (_SCALE_BYTES if method == "int8" else 0)


def tree_wire_bytes(op: str, method: str, leaves, axis_size: int) -> int:
    """Sum of :func:`wire_bytes` over tensors or shapes."""
    total = 0
    for leaf in leaves:
        shape = tuple(getattr(leaf, "shape", leaf))
        itemsize = leaf.element_size() if isinstance(leaf, torch.Tensor) \
            else 4
        total += wire_bytes(op, method, shape, axis_size, itemsize)
    return total


def fsdp_wire_stats(shapes, dims, axis_size: int, method: str) -> dict:
    """A step's wire bytes for the explicit FSDP dataflow (one gather and
    one reduce-scatter of every leaf ``dims`` marks split), beside the
    f32 bytes of the same collectives."""
    gather = scatter = gather_fp32 = scatter_fp32 = 0
    for shape, d in zip(shapes, dims):
        if d < 0:
            continue
        shape = tuple(shape)
        block = tuple(s // axis_size if i == d else s
                      for i, s in enumerate(shape))
        gather += wire_bytes("all_gather", method, block, axis_size)
        scatter += wire_bytes("reduce_scatter", method, shape, axis_size)
        gather_fp32 += wire_bytes("all_gather", "none", block, axis_size)
        scatter_fp32 += wire_bytes("reduce_scatter", "none", shape,
                                   axis_size)
    return {"all_gather_bytes": gather, "reduce_scatter_bytes": scatter,
            "all_gather_fp32_bytes": gather_fp32,
            "reduce_scatter_fp32_bytes": scatter_fp32}


# --------------------------------------------------------------------------
# error-feedback state
# --------------------------------------------------------------------------

def attach_residual(state, named_params) -> dict:
    """Zero-init this rank's error-feedback buffer on
    ``state.comm_residual``: one tensor a parameter, shaped like it, by
    name (JAX's holds every rank's on a leading axis; a checkpoint saves
    it so)."""
    state.comm_residual = {n: torch.zeros_like(p.detach())
                           for n, p in named_params}
    return state.comm_residual


# --------------------------------------------------------------------------
# the explicit-collective FSDP step
# --------------------------------------------------------------------------

def _same(t):
    return t


def shard_dim(shape, axis_size: int) -> int:
    """Which dim of a flax-layout ``shape`` the JAX rule splits over the
    comm axis (-1: the leaf stays whole):
    :func:`..parallel.zero.leaf_shard_spec`."""
    from distributed_deep_learning_tpu_torch.parallel.zero import \
        leaf_shard_spec

    spec = leaf_shard_spec(torch.empty(tuple(shape), device="meta"),
                           axis_size)
    for i, entry in enumerate(spec):
        if entry is not None:
            return i
    return -1


def flax_layouts(model: nn.Module) -> Callable:
    """``name -> (to_flax, from_flax)`` for ``model``'s parameters: the
    model's own ``flax_layout`` where it has one, else flax's kernels for
    torch's layers (a ``Linear`` weight ``(out, in)`` as ``(in, out)``, a
    convolution's ``(out, in, *k)`` as ``(*k, in, out)``), every other
    parameter as it is."""
    own = getattr(model, "flax_layout", None)
    if own is not None:
        return own
    perms = {}
    for prefix, m in model.named_modules():
        name = f"{prefix}.weight" if prefix else "weight"
        if isinstance(m, nn.Linear):
            perms[name] = (1, 0)
        elif isinstance(m, nn.modules.conv._ConvNd):
            k = m.weight.dim() - 2
            perms[name] = tuple(range(2, 2 + k)) + (1, 0)

    def layout(name: str):
        perm = perms.get(name)
        if perm is None:
            return _same, _same
        inv = tuple(perm.index(i) for i in range(len(perm)))
        return (lambda t: t.permute(perm), lambda t: t.permute(inv))

    return layout


class ExplicitFSDP:
    """``--zero fsdp --comm``: the ZeRO-3 dataflow written out on plain
    tensors.  ``model`` keeps whole parameters on every rank (the
    gathered values the forward reads); :attr:`masters` holds what the
    optimizer updates: for each leaf that JAX's rule splits over the comm
    group, this rank's shard of it **in its flax layout**
    (:func:`flax_layouts`), so the split dim and every shard-local
    statistic (``--clip-norm``, LAMB's trust ratio, Adafactor's factors)
    cover JAX's elements; the model's own parameter for the rest.
    ``layout`` is the rank's ``runtime.mesh.MeshLayout``."""

    def __init__(self, model: nn.Module, layout, method: str = "none",
                 overlap: bool = False):
        if method not in METHODS:
            raise ValueError(f"unknown comm method {method!r}; choose from "
                             f"{METHODS}")
        axis = layout.comm_axis
        self.size = layout.sizes[axis]
        if self.size <= 1:
            raise ValueError(f"explicit FSDP collectives need a >1 {axis!r} "
                             "mesh axis (nothing to gather/scatter)")
        self.model, self.method, self.overlap = model, method, overlap
        self.group, self.other = layout.comm_group, layout.other_group
        self.index = layout.coord[axis]
        self.batch_group = layout.batch_group
        self.batch_rank, self.batch_world = layout.batch_rank, \
            layout.batch_world
        self.params = dict(model.named_parameters())
        flax = flax_layouts(model)
        self.flax = {n: flax(n) for n in self.params}
        self.shapes = {n: tuple(self.flax[n][0](
            torch.empty(p.shape, device="meta")).shape)
            for n, p in self.params.items()}
        self.dims = {n: shard_dim(self.shapes[n], self.size)
                     for n in self.params}
        self.masters = {}
        for n, p in self.params.items():
            d = self.dims[n]
            self.masters[n] = p if d < 0 else nn.Parameter(
                self.part(self.flax[n][0](p.detach()), d).clone(
                    memory_format=torch.contiguous_format))
        self.exact = True          # the model holds the masters' values

    def part(self, full: torch.Tensor, d: int) -> torch.Tensor:
        """This rank's block of ``full`` along ``d``."""
        return full.chunk(self.size, d)[self.index]

    def layout(self, model_layout):
        """The optimizer's flax layouts (Adafactor's factoring) for the
        masters: the model's for whole leaves; a shard is in its flax
        layout already."""
        if model_layout is None:
            return None
        same = (_same, _same)
        return lambda n: model_layout(n) if self.dims[n] < 0 else same

    def wire_stats(self) -> dict:
        """:func:`fsdp_wire_stats` of this model."""
        names = list(self.params)
        return fsdp_wire_stats([self.shapes[n] for n in names],
                               [self.dims[n] for n in names], self.size,
                               self.method)

    @torch.no_grad()
    def gather(self, exact: bool = False) -> None:
        """Write every split leaf's gathered value into the model: through
        ``method``'s wire format, or ``exact`` (f32, for evaluation and
        checkpoints; skipped when the model holds them already)."""
        if exact and self.exact:
            return
        method = "none" if exact else self.method
        for n, p in self.params.items():
            d = self.dims[n]
            if d < 0:
                continue
            x0 = self.masters[n].detach().movedim(d, 0).contiguous()
            g = all_gather(x0, self.group, method=method,
                           overlap=self.overlap and not exact)
            p.copy_(self.flax[n][1](g.movedim(0, d)))
        self.exact = exact or method == "none"

    @torch.no_grad()
    def reduce_gradients(self, residual: dict | None) -> None:
        """The model's local gradients -> each master's ``grad``: summed
        over the other batch axes first, reduce-scattered over the comm
        group in the flax layout (error feedback through ``residual``,
        updated in place), whole leaves all-reduced in full precision;
        all divided by the batch ranks."""
        for n, p in self.params.items():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            if self.other is not None:
                g = g.contiguous().clone()
                dist.all_reduce(g, group=self.other)
            d = self.dims[n]
            if d < 0:
                g = g.contiguous().clone()
                dist.all_reduce(g, group=self.group)
                p.grad = g / self.batch_world
                continue
            to_flax, from_flax = self.flax[n]
            g0 = to_flax(g).movedim(d, 0).contiguous()
            if residual is None:
                out = reduce_scatter(g0, self.group, method=self.method,
                                     overlap=self.overlap)
            else:
                r0 = to_flax(residual[n]).movedim(d, 0)
                out, r0 = reduce_scatter(g0, self.group, method=self.method,
                                         overlap=self.overlap, residual=r0)
                residual[n].copy_(from_flax(r0.movedim(0, d)))
            self.masters[n].grad = (out / self.batch_world).movedim(0, d) \
                .contiguous()
            p.grad = None
        self.exact = False      # the update about to run moves the masters

    # -- checkpoints ---------------------------------------------------------
    def whole_optimizer(self, optimizer, writer: bool) -> dict | None:
        """The optimizer's state dict (every rank of the comm group calls
        it): a split leaf's moments shaped like its shard gathered whole,
        in the torch layout, as a ``--zero fsdp`` checkpoint holds them;
        its shard-local statistics (Adafactor's factored moments of the
        shard) stacked on a leading axis in comm-rank order, their keys
        listed under ``"shard_local"``."""
        sd = optimizer.state_dict()
        masters = [p for g in optimizer.param_groups for p in g["params"]]
        by_id = {id(m): n for n, m in self.masters.items()}
        state, shard_local = {}, {}
        for i in sorted(sd["state"]):
            n = by_id[id(masters[i])]
            d = self.dims[n]
            state[i] = {}
            for k, v in sd["state"][i].items():
                if d >= 0 and isinstance(v, torch.Tensor) and v.dim():
                    if v.shape == self.masters[n].shape:
                        v = self.flax[n][1](self._whole(v, d))
                    else:
                        v = _plain_gather(v.unsqueeze(0), self.group)
                        shard_local.setdefault(i, []).append(k)
                state[i][k] = v
        return {**sd, "state": state, "shard_local": shard_local} \
            if writer else None

    def _whole(self, part: torch.Tensor, d: int) -> torch.Tensor:
        x0 = part.movedim(d, 0).contiguous()
        return _plain_gather(x0, self.group).movedim(0, d)

    @torch.no_grad()
    def load(self, params: dict, optimizer, opt_sd: dict) -> None:
        """Whole parameters and moments, and each comm rank's shard-local
        statistics (a ``--comm`` checkpoint's), into this rank's layout."""
        self.model.load_state_dict(params)
        masters = [p for g in optimizer.param_groups for p in g["params"]]
        by_id = {id(m): n for n, m in self.masters.items()}
        for n, m in self.masters.items():
            if self.dims[n] >= 0:
                m.copy_(self.part(self.flax[n][0](self.params[n].detach()),
                                  self.dims[n]))
        opt_sd = dict(opt_sd)
        shard_local = opt_sd.pop("shard_local", {})
        state = {}
        for i, st in opt_sd["state"].items():
            n = by_id[id(masters[int(i)])]
            d = self.dims[n]
            state[i] = {}
            for k, v in st.items():
                if d >= 0 and isinstance(v, torch.Tensor) and v.dim():
                    if k in shard_local.get(i, ()):
                        v = v[self.index].clone()
                    elif tuple(v.shape) == tuple(self.params[n].shape):
                        v = self.part(self.flax[n][0](v), d).clone(
                            memory_format=torch.contiguous_format)
                    else:
                        raise ValueError(
                            f"checkpoint holds {k!r} of the whole {n!r}, "
                            "a statistic --comm keeps for each rank's "
                            "shard: resume with the flags that saved it")
                state[i][k] = v
        optimizer.load_state_dict({**opt_sd, "state": state})
        self.exact = True


def gather_residual(state) -> dict | None:
    """Every batch rank's residual stacked on a leading axis ``(n, ...)``
    in batch-rank order, as JAX's state holds it (every rank calls it)."""
    if state.comm_residual is None:
        return None
    comm = state.comm
    out = {}
    for n, r in state.comm_residual.items():
        parts = r.new_empty((comm.batch_world,) + tuple(r.shape))
        dist.all_gather_into_tensor(parts, r.unsqueeze(0).contiguous(),
                                    group=comm.batch_group)
        out[n] = parts
    return out


@torch.no_grad()
def load_residual(state, saved: dict) -> None:
    """This rank's residual from a checkpoint's stacked ones."""
    for n, r in state.comm_residual.items():
        r.copy_(saved[n][state.comm.batch_rank])


def make_fsdp_step_fns(loss_fn: Callable, comm: ExplicitFSDP, *,
                       remat: bool = False, remat_policy: str = "nothing",
                       registry=None):
    """``(train_step, eval_step)`` of ``--zero fsdp --comm``
    (:class:`ExplicitFSDP`): each rank's loss, BatchNorm statistics and
    routing are its own shard's, averaged over the batch ranks as JAX's
    ``shard_map`` does; evaluation reads the exactly gathered model.
    With a ``registry`` (:class:`..obs.metrics.MetricsRegistry`) each
    train step adds its wire bytes (:meth:`ExplicitFSDP.wire_stats`) to
    ``comm_bytes{op=all_gather|reduce_scatter, method=...}``, as JAX's
    counted step does."""
    from distributed_deep_learning_tpu_torch.train.step import make_step_fns

    train_step, eval_step = make_step_fns(
        loss_fn, remat=remat, remat_policy=remat_policy, global_batch=True,
        group=comm.batch_group, local_mean=True, comm=comm)
    if registry is None:
        return train_step, eval_step
    stats = comm.wire_stats()
    gathered = registry.counter("comm_bytes", op="all_gather",
                                method=comm.method)
    scattered = registry.counter("comm_bytes", op="reduce_scatter",
                                 method=comm.method)

    def train_step_counted(state, x, y):
        gathered.inc(stats["all_gather_bytes"])
        scattered.inc(stats["reduce_scatter_bytes"])
        return train_step(state, x, y)

    return train_step_counted, eval_step
