"""Trace-driven load generation with per-request SLOs.

The serving claims this repo makes (prefix reuse pays, chunked prefill
bounds stalls, speculation speeds decode) are claims about BEHAVIOR
UNDER LOAD, so the load itself has to be a first-class, seeded,
replayable object — not an ad-hoc loop in each bench script.  A
:class:`LoadSpec` describes a traffic mix the way a production trace
would: an arrival process (everything-up-front, Poisson, or bursty), a
bimodal prompt-length mix (chat-short vs document-long), an optional
shared system prompt carried by a fraction of requests (the prefix-
cache's bread and butter), and per-request TTFT / end-to-end SLOs.
:func:`make_load` turns a spec into concrete ``Request`` objects;
:func:`slo_report` scores measured latencies into the attainment
numbers the bench records and ``bench.py`` baselines track.

Everything is driven by one ``numpy`` generator seed: the same spec +
seed is the same trace, tokens and arrival ticks included, which is
what makes latency regressions reproducible.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from distributed_deep_learning_tpu_torch.serve.scheduler import Request


@dataclasses.dataclass(frozen=True)
class LoadSpec:
    """A replayable traffic description."""

    n_requests: int = 32
    arrival: str = "front"        # front | poisson | bursty
    rate: float = 1.0             # poisson: mean arrivals per tick
    burst_every: int = 16         # bursty: ticks between bursts
    burst_size: int = 8           # bursty: requests per burst
    prompt_short: tuple = (4, 16)     # inclusive length range
    prompt_long: tuple = (48, 96)
    long_frac: float = 0.25       # fraction of prompts from the long mode
    shared_prefix_len: int = 0    # system-prompt tokens (0 = none)
    shared_frac: float = 0.0      # fraction of requests carrying it
    new_tokens: tuple = (4, 32)   # max_new_tokens range
    slo_ttft_ms: Optional[float] = None   # applied to every request
    slo_e2e_ms: Optional[float] = None
    #: optional priority mix: ((priority, fraction), ...) — fractions
    #: must sum to 1.  None keeps every request at the Request default,
    #: AND keeps the legacy rng draw sequence (traces stay bit-stable).
    priority_classes: Optional[tuple] = None

    def __post_init__(self):
        if self.n_requests < 1:
            raise ValueError("n_requests must be >= 1")
        if self.arrival not in ("front", "poisson", "bursty"):
            raise ValueError(f"unknown arrival process {self.arrival!r}")
        if not 0.0 <= self.long_frac <= 1.0:
            raise ValueError("long_frac must be in [0, 1]")
        if not 0.0 <= self.shared_frac <= 1.0:
            raise ValueError("shared_frac must be in [0, 1]")
        if self.priority_classes is not None:
            pcs = tuple(self.priority_classes)
            if not pcs:
                raise ValueError("priority_classes must be non-empty "
                                 "when given")
            prios = [p for p, _ in pcs]
            if any(not isinstance(p, int) or isinstance(p, bool) or p < 0
                   for p in prios):
                raise ValueError("priority_classes priorities must be "
                                 "non-negative ints")
            if len(set(prios)) != len(prios):
                raise ValueError("priority_classes priorities must be "
                                 "unique")
            if any(f < 0 for _, f in pcs):
                raise ValueError("priority_classes fractions must be "
                                 ">= 0")
            if abs(sum(f for _, f in pcs) - 1.0) > 1e-6:
                raise ValueError("priority_classes fractions must sum "
                                 "to 1")


def _arrival_ticks(spec: LoadSpec, rng: np.random.Generator) -> np.ndarray:
    n = spec.n_requests
    if spec.arrival == "front":
        return np.zeros(n, np.int64)
    if spec.arrival == "poisson":
        gaps = rng.exponential(1.0 / max(spec.rate, 1e-9), size=n)
        return np.floor(np.cumsum(gaps) - gaps[0]).astype(np.int64)
    # bursty: groups of burst_size landing together every burst_every ticks
    return (np.arange(n) // max(spec.burst_size, 1)
            * max(spec.burst_every, 1)).astype(np.int64)


def make_load(spec: LoadSpec, vocab_size: int, seed: int = 0,
              pad_id: int = 0) -> list:
    """Materialise a spec into ``Request`` objects, arrival-sorted.

    Token ids are drawn from ``[1, vocab)`` so ``pad_id`` (0 by model
    convention) never appears inside a prompt.  The shared system prompt
    is ONE fixed random sequence per trace — every carrying request
    starts with the same tokens, so a prefix cache should prefill it
    once and hit thereafter."""
    if vocab_size < 3:
        raise ValueError("vocab_size too small for non-pad tokens")
    rng = np.random.default_rng(seed)
    lo = 1 if pad_id == 0 else 0

    def toks(n):
        return rng.integers(lo, vocab_size, size=n, dtype=np.int64)

    sys_prompt = toks(spec.shared_prefix_len)
    ticks = _arrival_ticks(spec, rng)
    reqs = []
    for uid in range(spec.n_requests):
        band = spec.prompt_long if rng.random() < spec.long_frac \
            else spec.prompt_short
        plen = int(rng.integers(band[0], band[1] + 1))
        prompt = toks(plen)
        if spec.shared_prefix_len and rng.random() < spec.shared_frac:
            prompt = np.concatenate([sys_prompt, prompt])
        new = int(rng.integers(spec.new_tokens[0],
                               spec.new_tokens[1] + 1))
        prio = 1                     # the Request default
        if spec.priority_classes is not None:
            # drawn LAST so a priority-free spec replays the exact
            # legacy rng sequence (existing traces stay bit-stable)
            pcs = spec.priority_classes
            prio = int(rng.choice([p for p, _ in pcs],
                                  p=np.asarray([f for _, f in pcs])
                                  / sum(f for _, f in pcs)))
        reqs.append(Request(
            uid=uid, prompt=prompt, max_new_tokens=new,
            arrival_tick=int(ticks[uid]),
            slo_ttft_ms=spec.slo_ttft_ms, slo_e2e_ms=spec.slo_e2e_ms,
            priority=prio))
    reqs.sort(key=lambda r: (r.arrival_tick, r.uid))
    return reqs


def _slo_score(requests, ttft_s: dict, e2e_s: dict) -> dict:
    checked = attained = ttft_miss = e2e_miss = 0
    for r in requests:
        has = False
        ok = True
        if r.slo_ttft_ms is not None:
            has = True
            if ttft_s.get(r.uid, math.inf) * 1e3 > r.slo_ttft_ms:
                ok = False
                ttft_miss += 1
        if r.slo_e2e_ms is not None:
            has = True
            if e2e_s.get(r.uid, math.inf) * 1e3 > r.slo_e2e_ms:
                ok = False
                e2e_miss += 1
        if has:
            checked += 1
            attained += int(ok)
    return {
        "slo_checked": checked,
        "slo_attained": attained,
        "slo_attainment": (attained / checked) if checked else None,
        "slo_ttft_misses": ttft_miss,
        "slo_e2e_misses": e2e_miss,
    }


def slo_report(requests, ttft_s: dict, e2e_s: dict) -> dict:
    """Score measured latencies against each request's SLOs.

    ``ttft_s`` / ``e2e_s`` map request uid -> measured seconds; a
    request missing its measurement counts as a miss (it never finished
    inside the run).  Requests with no SLO attached are excluded from
    attainment — ``slo_attainment`` is ``None`` when nothing was
    checked, so downstream consumers can tell "no SLOs" from "0%".

    ``by_priority`` breaks the same score down per priority class
    (string keys, JSON-stable) — the fleet-tier answer to "did the
    degradation land on the requests that could afford it"."""
    requests = list(requests)
    rep = _slo_score(requests, ttft_s, e2e_s)
    rep["by_priority"] = {
        str(p): _slo_score([r for r in requests if r.priority == p],
                           ttft_s, e2e_s)
        for p in sorted({r.priority for r in requests})}
    return rep


def merge_slo_reports(reports, classes=None) -> dict:
    """Fold per-replica :func:`slo_report` dicts into one fleet-level
    report: counts sum, attainment is recomputed from the summed counts
    (NOT averaged — replicas see different request counts), and the
    ``by_priority`` breakdowns merge class-wise.

    ``classes`` (optional) is the expected priority-class universe (any
    ints or strings; normalised to the reports' string keys).  Classes
    no replica reported — every request of that priority landed
    elsewhere this round, or none arrived at all — still appear, with
    zero counts and ``slo_attainment`` None, so fleet-level attainment
    is comparable across rounds instead of silently changing shape."""
    reports = [r for r in reports if r]
    checked = sum(r["slo_checked"] for r in reports)
    attained = sum(r["slo_attained"] for r in reports)
    merged = {
        "slo_checked": checked,
        "slo_attained": attained,
        "slo_attainment": (attained / checked) if checked else None,
        "slo_ttft_misses": sum(r["slo_ttft_misses"] for r in reports),
        "slo_e2e_misses": sum(r["slo_e2e_misses"] for r in reports),
    }
    seen = {p for r in reports for p in r.get("by_priority", {})}
    expected = {str(p) for p in classes} if classes is not None else set()
    all_classes = sorted(seen | expected)
    if all_classes:
        merged["by_priority"] = {}
        for p in all_classes:
            subs = [r["by_priority"][p] for r in reports
                    if p in r.get("by_priority", {})]
            c = sum(s["slo_checked"] for s in subs)
            a = sum(s["slo_attained"] for s in subs)
            merged["by_priority"][p] = {
                "slo_checked": c,
                "slo_attained": a,
                "slo_attainment": (a / c) if c else None,
                "slo_ttft_misses": sum(s["slo_ttft_misses"]
                                       for s in subs),
                "slo_e2e_misses": sum(s["slo_e2e_misses"]
                                      for s in subs),
            }
    return merged
