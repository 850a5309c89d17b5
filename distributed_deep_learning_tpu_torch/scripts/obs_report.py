"""Render a run's telemetry stream as a human-readable report: the
counterpart of ``scripts/obs_report.py``, over the port's
:mod:`..obs.export` and :mod:`..obs.trace`.  Host code only.

Reads the JSONL event stream a ``--obs`` run writes (the training CLI's,
``scripts.serve_bench``'s) — goodput breakdowns, the MFU record, the
metrics snapshot, serving stats — and prints what fraction of wall-clock
was productive, what stalled the run, what MFU the card achieved and
what latency users saw.  For a given stream the text is the JAX
script's, character for character; a field the stream lacks prints the
JAX script's own ``n/a`` form.

    python -m distributed_deep_learning_tpu_torch.scripts.obs_report \
        obs_events.jsonl
    ... obs_events.jsonl --phases   # per-phase goodput too
    ... obs_events.jsonl --prom     # Prometheus text
    ... obs_events.jsonl --trace    # span trace (path from the stream)
    ... obs_events.jsonl --window   # live windows
    ... obs_events.jsonl --memory   # memory view

``--prom`` dumps the final metrics snapshot in Prometheus text exposition
format instead of the report.  ``--trace`` summarises the Chrome/Perfetto
span trace (per-request causal chains: queued wait, prefill chunks,
decode count, prefix hits); the path comes from the stream's
``obs_trace`` event, or ``--trace PATH``.  ``--window`` prints the
rolling-window live signals (``obs_window`` events).
"""

from __future__ import annotations

import argparse
import os
import sys


def _fmt_frac(f: float) -> str:
    return f"{100.0 * f:5.1f}%"


def _goodput_block(gp: dict, indent: str = "  ") -> list[str]:
    order = ("productive", "input_stall", "checkpoint", "recovery",
             "compile", "other")
    lines = [f"{indent}wall {gp['wall_seconds']:.2f}s, "
             f"{gp['steps']} steps"]
    for cat in order:
        frac = gp["fractions"].get(cat, 0.0)
        sec = gp["seconds"].get(cat, 0.0)
        bar = "#" * int(round(40 * frac))
        lines.append(f"{indent}{cat:<12}{_fmt_frac(frac)}  "
                     f"{sec:8.3f}s  {bar}")
    return lines


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024.0 or unit == "GiB":
            return f"{n:.1f}{unit}"
        n /= 1024.0
    return f"{n:.1f}GiB"  # pragma: no cover


def _comm_block(snapshot: dict) -> list[str]:
    """Collective wire traffic: ``comm_bytes{method,op}`` counters from
    the explicit FSDP step (parallel/collectives.py) plus the measured
    ring-overlap fraction gauge when a comm bench ran."""
    counters = snapshot.get("counters", {})
    gauges = snapshot.get("gauges", {})
    lines = []
    for key in sorted(counters):
        if key.startswith("comm_bytes{"):
            labels = key[len("comm_bytes{"):-1]
            lines.append(f"  {labels:<38}{_fmt_bytes(counters[key]):>12}")
    frac = gauges.get("comm_overlap_fraction")
    if frac is not None:
        lines.append(f"  overlap fraction {_fmt_frac(frac)}")
    return lines


def _span_ms(spans: list[dict], name: str) -> tuple[int, float]:
    """(count, summed duration ms) of the named spans."""
    picked = [s for s in spans if s["name"] == name]
    return len(picked), sum(s.get("dur", 0) for s in picked) / 1e3


def render_trace(spans: list[dict], limit: int = 40) -> str:
    """Per-request causal-chain summary of a ``ph:"X"`` span list
    (:func:`obs.trace.read_chrome_trace`).  One line per request trace,
    ordered by root-span start; non-request tracks (train, engine)
    roll up as name -> count/total."""
    from collections import defaultdict

    by_trace: dict[str, list[dict]] = defaultdict(list)
    for s in spans:
        by_trace[s.get("cat", "?")].append(s)

    reqs, other = [], []
    for tid, ss in by_trace.items():
        root = next((s for s in ss if s["name"] == "request"), None)
        (reqs if root is not None else other).append((tid, ss, root))
    reqs.sort(key=lambda r: r[2]["ts"])

    out = [f"== span trace ({len(spans)} spans, "
           f"{len(reqs)} request traces) =="]
    for tid, ss, root in reqs[:limit]:
        _, q_ms = _span_ms(ss, "queued")
        n_chunk, pf_ms = _span_ms(ss, "prefill_chunk")
        if not n_chunk:                       # v1 engine: single prefill
            n_chunk, pf_ms = _span_ms(ss, "prefill")
        n_dec, _ = _span_ms(ss, "decode")
        pm = next((s for s in ss if s["name"] == "prefix_match"), None)
        hit = ""
        if pm is not None and pm["args"].get("hit"):
            hit = f"  prefix-hit shared={pm['args'].get('shared_len')}"
        cow_n, _ = _span_ms(ss, "cow")
        cow = f"  cow x{cow_n}" if cow_n else ""
        out.append(f"  {tid:<8} e2e {root.get('dur', 0) / 1e3:9.1f}ms  "
                   f"queued {q_ms:8.1f}ms  "
                   f"prefill x{n_chunk} {pf_ms:8.1f}ms  "
                   f"decode x{n_dec}{hit}{cow}")
    if len(reqs) > limit:
        out.append(f"  ... {len(reqs) - limit} more request traces")
    for tid, ss, _ in sorted(other):
        out.append(f"  [{tid}]")
        names = sorted({s["name"] for s in ss})
        for name in names:
            n, ms = _span_ms(ss, name)
            out.append(f"    {name:<16} x{n:<5} {ms:10.1f}ms")
    return "\n".join(out)


def render_memory(events: list[dict]) -> str:
    """The run's memory story: the ``obs_memory`` rollup (HBM watermark
    timeline, host RSS) plus the final snapshot's ``mem_*`` /
    ``serve_kv_cache_bytes`` gauges."""
    mems = [e for e in events if e.get("event") == "obs_memory"]
    snaps = [e for e in events if e.get("event") == "obs_snapshot"]
    out = []
    for mem in mems[-1:]:
        out.append("== memory (run) ==")
        reports = mem.get("device_reports_memory")
        out.append(f"  samples {mem.get('samples')} over "
                   f"{mem.get('steps')} steps  "
                   f"(device reports memory: {reports})")
        if mem.get("peak_bytes"):
            out.append(f"  HBM peak        {_fmt_bytes(mem['peak_bytes'])}")
        if mem.get("host_rss_bytes"):
            out.append(f"  host RSS        "
                       f"{_fmt_bytes(mem['host_rss_bytes'])}")
        tail = mem.get("timeline_tail") or []
        if tail:
            out.append("  step   in-use        peak          peak-delta")
            for s in tail:
                out.append(
                    f"  {s.get('step', 0):<6}"
                    f"{_fmt_bytes(s.get('bytes_in_use', 0)):>10}  "
                    f"{_fmt_bytes(s.get('peak_bytes', 0)):>10}  "
                    f"{_fmt_bytes(s.get('peak_delta', 0)):>10}")
    if snaps:
        gauges = snaps[-1].get("snapshot", {}).get("gauges", {})
        rows = [(k, v) for k, v in sorted(gauges.items())
                if k.startswith("mem_") or "kv_cache_bytes" in k]
        if rows:
            out.append("== memory gauges (final snapshot) ==")
            for k, v in rows:
                out.append(f"  {k:<28}{_fmt_bytes(v):>12}")
    if not out:
        out.append("no obs_memory events or mem_* gauges in the stream "
                   "(was the run started with --obs?)")
    return "\n".join(out)


def render_window(events: list[dict]) -> str:
    """The rolling-window live signals over the run, one line per
    ``obs_window`` emit (engines emit at most one per second)."""
    wins = [e for e in events if e.get("event") == "obs_window"]
    if not wins:
        return ("no obs_window events (windows are emitted by serve "
                "engine runs with --obs)")
    t0 = wins[0].get("t", 0.0)
    out = [f"== live windows ({wins[0].get('window_s')}s rolling, "
           f"{len(wins)} samples) ==",
           "  t+s     ttft p50/p99 ms     itl p50/p99 ms   "
           "qdepth p50/max  occ   req/s   tok/s"]
    for w in wins:
        def ms(key):
            v = w.get(key)
            return f"{1e3 * v:8.1f}" if v is not None else "     n/a"
        out.append(
            f"  {w.get('t', 0.0) - t0:6.1f}"
            f"{ms('ttft_p50_s')}/{ms('ttft_p99_s')}"
            f"{ms('itl_p50_s')}/{ms('itl_p99_s')}"
            f"   {w.get('queue_depth_p50', 0):5.0f}/"
            f"{w.get('queue_depth_max', 0):<4.0f}"
            f"{w.get('occupancy_last', 0.0):6.1f}"
            f"{w.get('request_rate_per_s', 0.0):8.2f}"
            f"{w.get('token_rate_per_s', 0.0):8.1f}")
    return "\n".join(out)


def render(events: list[dict], phases: bool = False) -> str:
    run_gp = None
    phase_gps = []
    mfu = None
    serve = []
    snapshot = None
    for ev in events:
        kind = ev.get("event")
        if kind == "obs_goodput":
            if ev.get("scope") == "run":
                run_gp = ev
            else:
                phase_gps.append(ev)
        elif kind == "obs_mfu":
            mfu = ev
        elif kind == "obs_serve":
            serve.append(ev.get("stats", {}))
        elif kind == "obs_snapshot":
            snapshot = ev.get("snapshot", {})

    out = []
    if run_gp is not None:
        out.append("== goodput (run) ==")
        out += _goodput_block(run_gp)
    if phases and phase_gps:
        for gp in phase_gps:
            out.append(f"== goodput ({gp.get('scope')}) ==")
            out += _goodput_block(gp)
    if mfu is not None:
        out.append("== model FLOP utilization ==")
        sps = mfu.get("steps_per_sec")
        out.append(f"  steps/sec       "
                   f"{sps:.3f}" if sps else "  steps/sec       n/a")
        if mfu.get("step_flops"):
            out.append(f"  step FLOPs      {mfu['step_flops']:.3e} "
                       f"(x{mfu.get('n_devices')} "
                       f"{mfu.get('device_kind')})")
        if mfu.get("achieved_flops_per_sec"):
            out.append(f"  achieved FLOP/s "
                       f"{mfu['achieved_flops_per_sec']:.3e}")
        if mfu.get("mfu") is not None:
            src = mfu.get("peak_flops_source")
            src_note = f", peak source: {src}" if src else ""
            out.append(f"  MFU             {100.0 * mfu['mfu']:.2f}% "
                       f"(peak {mfu['peak_flops_per_chip']:.3e}/chip"
                       f"{src_note})")
        else:
            out.append("  MFU             n/a (no peak-FLOPs table entry "
                       "for this device; set DDL_OBS_PEAK_FLOPS)")
    if snapshot is not None:
        comm = _comm_block(snapshot)
        if comm:
            out.append("== collective wire traffic ==")
            out += comm
    for st in serve:
        lat = st.get("latency") or {}
        out.append("== serving latency ==")
        out.append(f"  requests {st.get('requests')}  "
                   f"tokens/sec {st.get('tokens_per_sec'):.1f}  "
                   f"occupancy {st.get('mean_slot_occupancy'):.2f}"
                   f"/{st.get('max_slots')}")
        if lat.get("measured_requests"):
            out.append(f"  ttft  p50 {1e3 * lat['ttft_p50_s']:8.2f}ms   "
                       f"p99 {1e3 * lat['ttft_p99_s']:8.2f}ms")
            out.append(f"  itl   p50 {1e3 * lat['itl_p50_s']:8.2f}ms   "
                       f"p99 {1e3 * lat['itl_p99_s']:8.2f}ms")
            out.append(f"  e2e   p50 {lat['e2e_p50_s']:8.3f}s    "
                       f"p99 {lat['e2e_p99_s']:8.3f}s")
    if not out:
        out.append("no obs events found (was the run started with --obs?)")
    return "\n".join(out)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="render an --obs telemetry stream as a goodput/MFU/"
                    "latency report")
    p.add_argument("stream", help="JSONL event file written by --obs")
    p.add_argument("--phases", action="store_true",
                   help="also print per-phase goodput breakdowns")
    p.add_argument("--prom", action="store_true",
                   help="dump the final metrics snapshot as Prometheus "
                        "text exposition instead of the report")
    p.add_argument("--trace", nargs="?", const="", default=None,
                   metavar="PATH",
                   help="summarise the exported span trace instead of "
                        "the report (path defaults to the stream's "
                        "obs_trace event)")
    p.add_argument("--window", action="store_true",
                   help="print the rolling-window live signals "
                        "(obs_window events) instead of the report")
    p.add_argument("--memory", action="store_true",
                   help="print the memory view (obs_memory rollup + "
                        "mem_*/kv-cache gauges) instead of the report")
    args = p.parse_args(argv)

    from distributed_deep_learning_tpu_torch.obs.export import (
        prometheus_text, read_events)

    events = list(read_events(args.stream))
    if args.trace is not None:
        from distributed_deep_learning_tpu_torch.obs.trace import \
            read_chrome_trace

        path = args.trace
        if not path:
            recs = [e for e in events if e.get("event") == "obs_trace"]
            if not recs:
                print("no obs_trace event in the stream (run with a "
                      "trace path, or pass --trace PATH)",
                      file=sys.stderr)
                return 1
            path = recs[-1]["path"]
            if not os.path.isabs(path):
                # The producer recorded the path relative to its own cwd;
                # resolve against the stream it sits next to.
                path = os.path.join(
                    os.path.dirname(os.path.abspath(args.stream)), path)
        print(render_trace(read_chrome_trace(path)))
        return 0
    if args.window:
        print(render_window(events))
        return 0
    if args.memory:
        print(render_memory(events))
        return 0
    if args.prom:
        snaps = [e for e in events if e.get("event") == "obs_snapshot"]
        if not snaps:
            print("no obs_snapshot event in the stream", file=sys.stderr)
            return 1
        sys.stdout.write(prometheus_text(snaps[-1]["snapshot"]))
        return 0
    print(render(events, phases=args.phases))
    return 0


if __name__ == "__main__":
    sys.exit(main())
