"""The serving engines' decode tick, captured once in a CUDA graph.

The flax engines compile their decode step once for the engine's lifetime
(``CountingJit``, whose trace count the tests hold at 1).  The eager
PyTorch tick pays the host for every small launch instead: a few hundred
a tick at GPT-2-small widths, several milliseconds against the card's
fraction of one.  :class:`DecodeTick` keeps the compile-once contract
with a CUDA graph:

* **staging**: the host fills :attr:`DecodeTick.host` (int64 numpy: the
  tick's tokens, positions, block tables, write targets) and the call
  copies it into one static device buffer before the body runs;
* **the body**, ``body(engine, staged) -> (logits, picked)``: the model
  forward through the tied head, the greedy argmax, the finiteness flag
  and the chosen token's log-probability, all on device with static
  shapes (:func:`head`).  The engine is
  passed in at each call, not held, so an engine and its tick form no
  reference cycle and a dropped engine frees its caches at once.

On the CPU the body runs eagerly every tick (and on the card too when
:attr:`DecodeTick.graphed` is set false, an A/B of the capture).  On the
card the first tick runs it once on the capture stream (the warm-up,
whose outputs are that tick's), then captures it with
``torch.cuda.graph`` on the same stream; every later tick replays the
graph.  Every tick of the process shares one capture stream per device,
because PyTorch keeps a cuBLAS workspace for each stream it meets and
never frees it.  ``captures`` counts the captures, the counterpart of the
flax compile count: 1 for an engine's lifetime on the card, 0 on the CPU.
A failed capture raises; nothing falls back to eager.

Allocations the body makes while it is captured (the decode wrapper's
output and split-K workspace among them) come from the graph's private
pool and are reused by every replay.  A kernel wrapper's ``launches``
counter is a Python integer the capture bumps without launching anything
and a replay does not bump at all, so the capture's increments are taken
back and added again on every replay: a counter still reads the launches
the card really ran.
"""

from __future__ import annotations

import numpy as np
import torch

from distributed_deep_learning_tpu_torch.models.transformer import \
    pick_tokens


#: the capture stream of each device (see the module docstring)
_CAPTURE_STREAMS: dict[int, torch.cuda.Stream] = {}


def capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The one stream every :class:`DecodeTick` on ``device`` warms up and
    captures on."""
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    if index not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[index] = torch.cuda.Stream(index)
    return _CAPTURE_STREAMS[index]


def chosen_logprob(logits, tokens):
    """Log-probability of ``tokens`` ``(S,)`` under f32 ``logits`` ``(S,
    V)``: the drift signal a canary compares between weight sets."""
    return torch.log_softmax(logits, dim=-1).gather(
        -1, tokens[:, None])[:, 0]


def head(model, hidden):
    """The tick's tail on device: ``hidden`` ``(S, d)`` through the tied
    head to f32 logits ``(S, V)`` (pad id masked), and ``picked`` ``(3,
    S)`` f64: the greedy tokens, a 0/1 flag that the row's hidden state is
    finite (non-finite KV anywhere in a slot's attention shows here one
    tick later) and the greedy token's log-probability.  One host copy
    of ``picked`` carries all three."""
    logits = model.logits_from(hidden)
    greedy = pick_tokens(model, logits)
    finite = torch.isfinite(hidden).all(dim=-1)
    return logits, torch.stack([greedy.double(), finite.double(),
                                chosen_logprob(logits, greedy).double()])


class DecodeTick:
    """One engine's decode tick: ``body`` over a static int64 buffer of
    ``shape``, eager or captured once and replayed (see the module
    docstring).  ``counters`` are kernel wrappers whose ``launches`` the
    body bumps."""

    def __init__(self, body, shape, device: torch.device, *, counters=()):
        self.body = body
        self.device = device
        self.graphed = device.type == "cuda"
        self.counters = tuple(counters)
        self.host = np.zeros(shape, np.int64)
        self.staged = torch.zeros(shape, dtype=torch.int64, device=device)
        self.captures = 0
        self._graph = None
        self._out = None
        self._replay_launches = ()

    def __call__(self, engine):
        """Stage :attr:`host`, run ``engine``'s tick; returns ``(logits,
        picked)``, valid until the next call."""
        self.staged.copy_(torch.from_numpy(self.host))
        if not self.graphed:
            return self.body(engine, self.staged)
        if self._graph is None:
            return self._capture(engine)
        self._graph.replay()
        for counter, n in self._replay_launches:
            counter.launches += n
        return self._out

    def _capture(self, engine):
        main = torch.cuda.current_stream(self.device)
        side = capture_stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):           # warm-up: this tick's result
            out = self.body(engine, self.staged)
        main.wait_stream(side)
        before = [c.launches for c in self.counters]
        graph = torch.cuda.CUDAGraph()
        # thread_local: a helper thread of the process (NCCL's watchdog
        # after -m data training) may query the card during the capture
        with torch.cuda.graph(graph, stream=side,
                              capture_error_mode="thread_local"):
            static = self.body(engine, self.staged)
        self._replay_launches = tuple(
            (c, c.launches - n) for c, n in zip(self.counters, before))
        for counter, n in self._replay_launches:
            counter.launches -= n               # the capture launched nothing
        self._graph, self._out = graph, static
        self.captures += 1
        return out
