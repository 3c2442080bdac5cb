"""Exporters for the obs registry: Chrome-trace/Perfetto JSON, JSONL,
the benchmark JSON log sink, and the per-stage summary table (the port's
copy of ``tnc_tpu.obs.export``).

The Chrome trace format is the least-common-denominator timeline schema
(``ui.perfetto.dev`` and ``chrome://tracing`` both load it): a
``traceEvents`` list where every slice is a balanced ``B``/``E`` pair
carrying ``name``/``ts``/``pid``/``tid`` (timestamps in microseconds).
One exported file renders the whole pipeline — planning, partitioning,
slicing, hoisted prelude vs per-slice residual, chunked dispatches, SPMD
shard phases, fan-in — as one timeline.

>>> import tnc_tpu_torch.obs as obs
>>> from tnc_tpu_torch.obs.core import MetricsRegistry
>>> reg = obs.configure(enabled=True, registry=MetricsRegistry())
>>> with obs.span("sliced.prelude") as sp:
...     _ = sp.add(flops=64)
>>> events = chrome_trace_events(reg)
>>> [e["ph"] for e in events if e["name"] == "sliced.prelude"]
['B', 'E']
>>> rows = trace_summary(events)
>>> rows[0]["name"], rows[0]["count"], rows[0]["flops"]
('sliced.prelude', 1, 64.0)
>>> _ = obs.configure(enabled=False)
"""

from __future__ import annotations

import json
import logging
from typing import Any, Iterable

from tnc_tpu_torch.obs.core import MetricsRegistry, get_registry

logger = logging.getLogger(__name__)


def _warn_if_truncated(reg: MetricsRegistry, sink: str) -> int:
    """Spans past the retention cap (``TNC_TPU_TRACE_MAX_SPANS``) are
    counted but dropped; every exporter surfaces that loudly — a
    truncated trace must never read as a complete one. Returns the
    dropped count."""
    dropped = reg.dropped_spans()
    if dropped:
        logger.warning(
            "obs: span retention cap hit — %d spans were dropped; the "
            "%s export is PARTIAL (raise TNC_TPU_TRACE_MAX_SPANS to "
            "keep more)",
            dropped,
            sink,
        )
    return dropped


def chrome_trace_events(
    registry: MetricsRegistry | None = None,
    include_open: bool = True,
) -> list[dict]:
    """Registry spans → Chrome-trace event dicts (``B``/``E`` pairs plus
    process/thread ``M`` metadata), sorted by timestamp."""
    reg = registry if registry is not None else get_registry()
    events: list[dict] = []
    threads: dict[tuple[int, int], str] = {}
    for rec in reg.span_records(include_open=include_open):
        threads.setdefault((rec.pid, rec.tid), rec.thread_name)
        ts = rec.start_ns / 1e3  # Chrome trace timestamps are in µs
        common = {"name": rec.name, "cat": rec.name.split(".", 1)[0],
                  "pid": rec.pid, "tid": rec.tid}
        args = {k: _jsonable(v) for k, v in rec.args.items()}
        args["depth"] = rec.depth
        events.append({**common, "ph": "B", "ts": ts, "args": args})
        events.append({**common, "ph": "E", "ts": ts + rec.dur_ns / 1e3})
    # B before E at equal ts (zero-duration spans) keeps pairs balanced
    events.sort(key=lambda e: (e["ts"], 0 if e["ph"] != "E" else 1))
    meta = _process_meta({pid for pid, _tid in threads}) + [
        {"name": "thread_name", "ph": "M", "ts": 0.0, "pid": pid, "tid": tid,
         "args": {"name": tname}}
        for (pid, tid), tname in sorted(threads.items())
    ]
    return meta + events


def _process_meta(pids: set[int]) -> list[dict]:
    """``process_name`` metadata events carrying this replica's fleet
    identity (process index / hostname / pid) — a merged multi-host
    timeline then names every process track after the replica that
    produced it."""
    from tnc_tpu_torch.obs.fleet import replica_identity, replica_name

    ident = replica_identity()
    own_pid = ident["pid"]
    label = f"{replica_name(ident)} {ident['host']} pid={own_pid}"
    return [
        {"name": "process_name", "ph": "M", "ts": 0.0, "pid": pid, "tid": 0,
         "args": {"name": label if pid == own_pid and label else f"pid {pid}"}}
        for pid in sorted(pids)
    ]


def _jsonable(v: Any) -> Any:
    return v if isinstance(v, (str, int, float, bool, type(None))) else str(v)


def export_chrome_trace(
    path: str, registry: MetricsRegistry | None = None
) -> str:
    """Write the registry as a Chrome-trace JSON file loadable in
    ``ui.perfetto.dev``; counters/gauges ride along under ``otherData``
    (including ``dropped_spans``, warned about when nonzero). Returns
    ``path``."""
    reg = registry if registry is not None else get_registry()
    _warn_if_truncated(reg, "Chrome-trace")
    other = reg.snapshot()
    # fleet-merge anchors: the wall-clock twin of the span epoch places
    # this file on a cross-process timeline; the replica identity names
    # which host/process produced it
    other["epoch_unix_ns"] = getattr(reg, "epoch_unix_ns", None)
    from tnc_tpu_torch.obs.fleet import replica_identity

    other["replica"] = replica_identity()
    doc = {
        "traceEvents": chrome_trace_events(reg),
        "displayTimeUnit": "ms",
        "otherData": other,
    }
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(doc, fh)
    return path


def export_jsonl(path: str, registry: MetricsRegistry | None = None) -> str:
    """Write every span and metric as one JSON object per line (the
    flexi_logger-style record stream; round-trips through
    ``json.loads`` per line), histograms included, closing with a
    ``dropped_spans`` record so a capped trace is never silently
    partial. Returns ``path``."""
    reg = registry if registry is not None else get_registry()
    dropped = _warn_if_truncated(reg, "JSONL")
    with open(path, "w", encoding="utf-8") as fh:
        for rec in reg.span_records():
            fh.write(json.dumps({
                "type": "span", "name": rec.name,
                "start_s": rec.start_ns / 1e9, "dur_s": rec.dur_ns / 1e9,
                "pid": rec.pid, "tid": rec.tid, "depth": rec.depth,
                "args": {k: _jsonable(v) for k, v in rec.args.items()},
            }) + "\n")
        snap = reg.snapshot()
        for kind in ("counters", "gauges"):
            for name, value in snap[kind].items():
                fh.write(json.dumps(
                    {"type": kind[:-1], "name": name, "value": value}
                ) + "\n")
        for name, h in snap["histograms"].items():
            fh.write(json.dumps(
                {"type": "histogram", "name": name, **h}
            ) + "\n")
        fh.write(json.dumps(
            {"type": "dropped_spans", "value": dropped}
        ) + "\n")
    return path


def emit_metrics(
    logger: logging.Logger | None = None,
    registry: MetricsRegistry | None = None,
) -> int:
    """Log every metric — counters, gauges, histograms, span stats — as
    a structured record through the std logging tree, so
    a JSON formatter that serializes ``extra=`` fields lands them in a
    per-process JSONL sink. A ``dropped_spans`` record (warned about when nonzero) closes
    the stream. Returns the number of records emitted."""
    reg = registry if registry is not None else get_registry()
    lg = logger if logger is not None else logging.getLogger("tnc_tpu_torch.obs")
    dropped = _warn_if_truncated(reg, "metrics")
    n = 0
    snap = reg.snapshot()
    for kind in ("counters", "gauges"):
        for name, value in snap[kind].items():
            lg.info(
                "metric", extra={"metric_type": kind[:-1], "metric": name,
                                 "value": value},
            )
            n += 1
    for name, h in snap["histograms"].items():
        lg.info(
            "metric", extra={"metric_type": "histogram", "metric": name, **h},
        )
        n += 1
    for name, stats in reg.span_stats().items():
        lg.info(
            "metric", extra={"metric_type": "span", "metric": name, **stats},
        )
        n += 1
    lg.info(
        "metric",
        extra={
            "metric_type": "dropped_spans",
            "metric": "dropped_spans",
            "value": dropped,
        },
    )
    n += 1
    return n


def load_trace_events(path: str) -> list[dict]:
    """Read back a Chrome-trace JSON (either the ``{"traceEvents": []}``
    object or a bare event array)."""
    with open(path, encoding="utf-8") as fh:
        doc = json.load(fh)
    return doc["traceEvents"] if isinstance(doc, dict) else doc


def merge_trace_files(paths: Iterable[str]) -> dict:
    """Merge per-process Chrome-trace exports into ONE fleet timeline.

    Span timestamps are perf-counter-relative to each process's own
    registry epoch; every export since the fleet plane also carries the
    wall-clock twin of that epoch (``otherData.epoch_unix_ns``), so the
    merge shifts each file onto the earliest epoch and re-sorts. Files
    without the anchor (pre-fleet exports) merge unshifted — their
    spans still aggregate correctly, they just don't align in time.

    Returns ``{"events": [...], "replicas": [{path, replica,
    shift_ms}, ...]}`` — feed ``events`` to :func:`trace_summary` /
    :func:`serve_trace_rollup` for the cross-host view (the ``--fleet``
    mode of the repo's ``scripts/trace_summarize.py``).
    """
    docs: list[tuple[str, dict]] = []
    for path in sorted(str(p) for p in paths):
        with open(path, encoding="utf-8") as fh:
            doc = json.load(fh)
        if not isinstance(doc, dict):
            doc = {"traceEvents": doc, "otherData": {}}
        docs.append((path, doc))
    epochs = [
        (doc.get("otherData") or {}).get("epoch_unix_ns")
        for _path, doc in docs
    ]
    known = [e for e in epochs if e]
    base = min(known) if known else None
    events: list[dict] = []
    replicas: list[dict] = []
    for (path, doc), epoch in zip(docs, epochs):
        shift_us = (epoch - base) / 1e3 if (epoch and base) else 0.0
        for ev in doc.get("traceEvents", []):
            if shift_us and ev.get("ph") in ("B", "E"):
                ev = {**ev, "ts": ev["ts"] + shift_us}
            events.append(ev)
        replicas.append({
            "path": path,
            "replica": (doc.get("otherData") or {}).get("replica"),
            "shift_ms": shift_us / 1e3,
            "aligned": bool(epoch and base),
        })
    # metadata events (ts 0) first, then the same B-before-E tie-break
    # the per-process exporter uses; the sort is stable, so each file's
    # internal order survives ties and B/E pairs stay balanced per
    # (pid, tid)
    events.sort(key=lambda e: (
        0 if e.get("ph") == "M" else 1,
        e.get("ts", 0.0),
        0 if e.get("ph") != "E" else 1,
    ))
    return {"events": events, "replicas": replicas}


def trace_summary(events: Iterable[dict]) -> list[dict]:
    """Per-stage aggregate over Chrome-trace events: for every span name,
    the call count, total wall time, and the summed numeric counters the
    spans carried (flops, bytes, slices, ...). Rows are sorted by total
    time, descending. Only top-level occurrences of a name are summed
    when the same name nests inside itself."""
    open_spans: dict[tuple[int, int], list[tuple[str, float, dict]]] = {}
    agg: dict[str, dict] = {}
    for ev in events:
        ph = ev.get("ph")
        if ph not in ("B", "E"):
            continue
        key = (ev.get("pid", 0), ev.get("tid", 0))
        stack = open_spans.setdefault(key, [])
        if ph == "B":
            stack.append((ev["name"], ev["ts"], ev.get("args", {})))
            continue
        if not stack or stack[-1][0] != ev["name"]:  # unbalanced: skip
            continue
        name, ts0, args = stack.pop()
        if any(frame[0] == name for frame in stack):
            continue  # self-nested: the outer occurrence will count it
        row = agg.setdefault(
            name, {"name": name, "count": 0, "total_ms": 0.0}
        )
        row["count"] += 1
        row["total_ms"] += (ev["ts"] - ts0) / 1e3
        for k, v in args.items():
            if k != "depth" and isinstance(v, (int, float)):
                row[k] = row.get(k, 0.0) + float(v)
    return sorted(agg.values(), key=lambda r: -r["total_ms"])


def _completed_spans(events: Iterable[dict]) -> list[dict]:
    """Balanced ``B``/``E`` pairs → ``[{name, dur_ms, args}]``. A
    sibling of :func:`trace_summary`'s pairing walk, kept separate
    because that one needs the live stack for its self-nesting rule —
    keep the unbalanced-span handling of the two in agreement."""
    open_spans: dict[tuple[int, int], list[tuple[str, float, dict]]] = {}
    out: list[dict] = []
    for ev in events:
        ph = ev.get("ph")
        if ph not in ("B", "E"):
            continue
        key = (ev.get("pid", 0), ev.get("tid", 0))
        stack = open_spans.setdefault(key, [])
        if ph == "B":
            stack.append((ev["name"], ev["ts"], ev.get("args", {})))
            continue
        if not stack or stack[-1][0] != ev["name"]:  # unbalanced: skip
            continue
        name, ts0, args = stack.pop()
        out.append(
            {"name": name, "dur_ms": (ev["ts"] - ts0) / 1e3, "args": args}
        )
    return out


def serve_trace_rollup(events: Iterable[dict]) -> dict:
    """Roll ``serve.*`` spans up per request id and per query type.

    Two span families feed it (``tnc_tpu_torch.serve.service``):

    - ``serve.request`` — one terminal span per request whose args ARE
      the request timeline (rid, type, outcome, queue_age_s,
      batch_wait_s, dispatch_s, riders, generation);
    - ``serve.dispatch`` — one span per batched execution, its wall
      time shared by the ``riders`` id list it carries; the rollup
      attributes ``dur / len(riders)`` to each rider, so shared batch
      time lands on requests and query types without double counting.

    Returns ``{"requests": {rid: {...}}, "by_type": {kind: {...}},
    "dispatch_wall_ms", "attributed_ms", "attributed_share"}`` —
    ``attributed_share`` is the CI pin: the fraction of total dispatch
    wall time the rider lists account for (≥ 0.95 on a healthy trace).
    """
    requests: dict[str, dict] = {}
    by_type: dict[str, dict] = {}
    dispatch_wall = 0.0
    attributed = 0.0
    spans = _completed_spans(events)
    # two passes: request rows first, THEN dispatch attribution — a
    # request's serve.request span always closes after the dispatch
    # span that served it, so a single in-order pass would attribute
    # into rows that don't exist yet
    for span in spans:
        args = span["args"]
        if span["name"] == "serve.request":
            rid = str(args.get("rid", "?"))
            requests[rid] = {
                "type": args.get("type", "?"),
                "outcome": args.get("outcome", "?"),
                "latency_s": float(args.get("latency_s", 0.0) or 0.0),
                "queue_age_s": float(args.get("queue_age_s", 0.0) or 0.0),
                "batch_wait_s": float(args.get("batch_wait_s", 0.0) or 0.0),
                "dispatch_s": float(args.get("dispatch_s", 0.0) or 0.0),
                "riders": int(args.get("riders", 1) or 1),
                "generation": int(args.get("generation", 0) or 0),
                "attributed_ms": 0.0,
            }
    for span in spans:
        args = span["args"]
        if span["name"] == "serve.dispatch":
            dispatch_wall += span["dur_ms"]
            riders = [
                r for r in str(args.get("riders", "")).split(",") if r
            ]
            if not riders:
                continue
            share = span["dur_ms"] / len(riders)
            attributed += span["dur_ms"]
            kind = str(args.get("kind", "?"))
            row = by_type.setdefault(
                kind,
                {"dispatches": 0, "dispatch_ms": 0.0, "requests": 0},
            )
            row["dispatches"] += 1
            row["dispatch_ms"] += span["dur_ms"]
            for rid in riders:
                req = requests.get(rid)
                if req is not None:
                    req["attributed_ms"] += share
    for req in requests.values():
        row = by_type.setdefault(
            req["type"],
            {"dispatches": 0, "dispatch_ms": 0.0, "requests": 0},
        )
        row["requests"] += 1
        for fld in ("latency_s", "queue_age_s", "batch_wait_s", "dispatch_s"):
            row[f"{fld}_sum"] = row.get(f"{fld}_sum", 0.0) + req[fld]
    for row in by_type.values():
        n = max(row["requests"], 1)
        for fld in ("latency_s", "queue_age_s", "batch_wait_s", "dispatch_s"):
            row[f"{fld}_mean"] = row.pop(f"{fld}_sum", 0.0) / n
    return {
        "requests": requests,
        "by_type": by_type,
        "dispatch_wall_ms": dispatch_wall,
        "attributed_ms": attributed,
        "attributed_share": (
            attributed / dispatch_wall if dispatch_wall > 0 else 0.0
        ),
    }


def format_serve_rollup(rollup: dict) -> str:
    """Aligned text rendering of :func:`serve_trace_rollup` (the
    ``trace_summarize.py --serve`` output): one row per query type,
    then the attribution line."""
    head = (
        f"{'query type':<14} {'reqs':>6} {'dispatches':>11} "
        f"{'q-age ms':>9} {'wait ms':>9} {'disp ms':>9} {'lat ms':>9}"
    )
    lines = [head, "-" * len(head)]
    for kind in sorted(rollup["by_type"]):
        row = rollup["by_type"][kind]
        lines.append(
            f"{kind:<14} {row['requests']:>6} {row['dispatches']:>11} "
            f"{row.get('queue_age_s_mean', 0.0) * 1e3:>9.2f} "
            f"{row.get('batch_wait_s_mean', 0.0) * 1e3:>9.2f} "
            f"{row.get('dispatch_s_mean', 0.0) * 1e3:>9.2f} "
            f"{row.get('latency_s_mean', 0.0) * 1e3:>9.2f}"
        )
    lines.append(
        f"{len(rollup['requests'])} requests; dispatch wall "
        f"{rollup['dispatch_wall_ms']:.2f} ms, "
        f"{rollup['attributed_share']:.1%} attributed to request ids"
    )
    return "\n".join(lines)


def format_summary_table(rows: list[dict]) -> str:
    """Render :func:`trace_summary` rows as an aligned text table with a
    time-share column (the layout of the repo's
    ``scripts/trace_summarize.py``)."""
    total = sum(r["total_ms"] for r in rows) or 1.0
    extra_cols: list[str] = []
    for r in rows:
        for k in r:
            if k not in ("name", "count", "total_ms") and k not in extra_cols:
                extra_cols.append(k)
    head = (
        f"{'stage':<36} {'count':>7} {'total_ms':>12} {'share':>7}"
        + "".join(f" {c:>12}" for c in extra_cols)
    )
    lines = [head, "-" * len(head)]
    for r in rows:
        line = (
            f"{r['name']:<36} {r['count']:>7} {r['total_ms']:>12.2f} "
            f"{r['total_ms'] / total:>6.1%}"
        )
        for c in extra_cols:
            v = r.get(c)
            line += f" {v:>12.3g}" if isinstance(v, (int, float)) else " " * 13
        lines.append(line)
    return "\n".join(lines)
