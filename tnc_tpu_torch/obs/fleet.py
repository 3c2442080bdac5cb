"""Fleet observability plane: cross-host trace propagation, a replica
registry with heartbeats, federated telemetry, and a crash flight
recorder (the port's copy of ``tnc_tpu.obs.fleet``).

Everything in :mod:`tnc_tpu_torch.obs` up to here is process-local; a
multi-host serving fleet (``ClusterDispatcher`` / ``serve_cluster``)
leaves each replica with its own registry, its own trace file, and its
own ``/metrics`` — disconnected fragments. This module is the glue:

- :class:`TraceContext` — a serializable span-identity capsule (request
  ids, query kind, plan generation, dispatch sequence, root identity)
  that the root's dispatcher stashes in a thread-local around each
  batch (:func:`dispatch_context`), :class:`~tnc_tpu_torch.serve.multihost.
  ClusterDispatcher` ships inside its broadcast command, and the worker
  adopts (:func:`adopt_trace_context`) so its ``serve.dispatch`` /
  ``partitioned.*`` / slice spans carry the ROOT's request ids — the
  merged fleet timeline attributes cross-host dispatch wall time to the
  same rids the single-host rollup uses.
- :class:`FleetRegistry` — replica roster on a shared directory using
  the plan-cache discipline (unique-tmp atomic JSON writes, mtime-based
  staleness, corrupt entries dropped and counted, never raised). Each
  replica heartbeats identity + queue/SLO state on a cadence
  (:class:`Heartbeat`); any reader gets a live roster with join /
  stale / leave / reap transitions surfaced as obs counters + gauges.
- :class:`FleetAggregator` — root-side federation: scrapes every
  replica's ``/metrics`` (or falls back to heartbeat payloads), sums
  counters across replicas in deterministic order, keeps gauges and
  quantiles per-replica under a ``replica=`` label, and reports an
  honest pooled min/max envelope for quantile series — P² sketches do
  not merge exactly, so the endpoint never pretends they do. Feeds the
  ``/fleet`` route of :class:`~tnc_tpu_torch.obs.http.TelemetryServer`.
- :class:`FlightRecorder` — ``TNC_TPU_FLIGHT_RECORDER=<dir>``: a
  bounded ring of recent closed spans plus a counter snapshot, dumped
  atomically on fatal exceptions, SIGTERM, interpreter exit, AND on a
  short periodic cadence — so even a SIGKILL (the fault-injection
  ``kill`` kind, or a real preemption) leaves a parseable postmortem
  artifact no more than one flush interval stale.

>>> ctx = TraceContext(riders="r1,r2", kind="amplitude", generation=3)
>>> TraceContext.from_obj(ctx.to_obj()) == ctx
True
"""

from __future__ import annotations

import json
import logging
import os
import signal
import socket
import sys
import threading
import time
import uuid
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Iterable, Mapping

from tnc_tpu_torch.obs.core import get_registry

import tnc_tpu_torch.obs.core as _core

logger = logging.getLogger(__name__)


# -- replica identity ---------------------------------------------------


def _procs() -> tuple[int, int]:
    """(process_count, process_index) — from ``torch.distributed`` when a
    process group is up (:func:`~tnc_tpu_torch.obs.core.process_identity`,
    which never imports it), else (1, 0), so every caller degrades to
    single-replica behaviour. The reference asks ``jax.process_count()`` /
    ``jax.process_index()``."""
    return _core.process_identity()


def replica_identity() -> dict:
    """This process's fleet identity: distributed process index/count,
    hostname, pid. Every span file, heartbeat, flight-recorder dump and
    federated metric row carries (a projection of) this dict.

    >>> ident = replica_identity()
    >>> sorted(ident)
    ['host', 'pid', 'process', 'process_count']
    """
    n, me = _procs()
    return {
        "process": me,
        "process_count": n,
        "host": socket.gethostname(),
        "pid": os.getpid(),
    }


def replica_name(identity: Mapping | None = None) -> str:
    """Short roster/label name for a replica — ``p<process_index>``.
    Unique within one ``torch.distributed`` process group; callers outside a
    distributed runtime (tests, ad-hoc processes) should pass their own
    name to :class:`FleetRegistry` instead.

    >>> replica_name({"process": 3})
    'p3'
    """
    ident = identity if identity is not None else replica_identity()
    return f"p{ident.get('process', 0)}"


# -- cross-host trace propagation --------------------------------------


@dataclass(frozen=True)
class TraceContext:
    """The span identity a dispatch carries across the host boundary.

    ``riders`` is the same comma-joined request-id list the root's
    ``serve.dispatch`` span carries (``"r1,r2,..."``) — the merged
    trace rollup attributes each span's wall time over exactly this
    list, so a worker span wearing the context is indistinguishable
    (for attribution) from root-side dispatch time.
    """

    riders: str = ""
    kind: str = "?"
    generation: int = 0
    seq: int = 0
    root_process: int = 0
    root_pid: int = 0

    def to_obj(self) -> dict:
        """Plain-dict form for the ``broadcast_object`` channel."""
        return {
            "riders": self.riders,
            "kind": self.kind,
            "generation": self.generation,
            "seq": self.seq,
            "root_process": self.root_process,
            "root_pid": self.root_pid,
        }

    @classmethod
    def from_obj(cls, obj) -> "TraceContext | None":
        """Inverse of :meth:`to_obj`; tolerant of ``None`` and unknown
        keys (a version-skewed root must not crash a worker)."""
        if not isinstance(obj, Mapping):
            return None
        return cls(
            riders=str(obj.get("riders", "")),
            kind=str(obj.get("kind", "?")),
            generation=int(obj.get("generation", 0) or 0),
            seq=int(obj.get("seq", 0) or 0),
            root_process=int(obj.get("root_process", 0) or 0),
            root_pid=int(obj.get("root_pid", 0) or 0),
        )


_TLS = threading.local()


def current_dispatch_context() -> TraceContext | None:
    """The TraceContext of the dispatch currently executing on this
    thread (set by the service around its dispatcher call), or None."""
    return getattr(_TLS, "dispatch_ctx", None)


class _DispatchCtx:
    __slots__ = ("_ctx", "_prev")

    def __init__(self, ctx: TraceContext):
        self._ctx = ctx

    def __enter__(self) -> TraceContext:
        self._prev = getattr(_TLS, "dispatch_ctx", None)
        _TLS.dispatch_ctx = self._ctx
        return self._ctx

    def __exit__(self, *exc) -> bool:
        _TLS.dispatch_ctx = self._prev
        return False


def dispatch_context(
    riders: str = "", kind: str = "?", generation: int = 0, seq: int = 0
) -> _DispatchCtx:
    """Context manager the serving layer wraps around one batch
    dispatch: while active, :func:`current_dispatch_context` answers
    with this batch's identity, so a pluggable dispatcher (whose
    ``fn(bound, bits, backend)`` signature carries no request ids) can
    recover the rid list to ship across hosts.

    >>> with dispatch_context(riders="r7", kind="amplitude") as ctx:
    ...     current_dispatch_context().riders
    'r7'
    >>> current_dispatch_context() is None
    True
    """
    n, me = _procs()
    return _DispatchCtx(TraceContext(
        riders=riders, kind=kind, generation=generation, seq=seq,
        root_process=me, root_pid=os.getpid(),
    ))


def adopt_trace_context(ctx: TraceContext | None):
    """Worker-side adoption: every span opened on this thread while the
    context manager is active carries the root's request ids (and the
    dispatch's generation/sequence) as span args — ``serve.dispatch``,
    ``partitioned.*`` and slice spans all land in the merged timeline
    already attributed. No-op (identity) for a None context."""
    if ctx is None:
        return _core.trace_args()
    return _core.trace_args(
        riders=ctx.riders,
        generation=ctx.generation,
        seq=ctx.seq,
        root_process=ctx.root_process,
    )


# -- replica registry with heartbeats ----------------------------------


class FleetRegistry:
    """Replica roster on a shared directory — the same multi-writer
    discipline as :class:`~tnc_tpu_torch.serve.plancache.PlanCache`: each
    write goes through a uniquely named temp file + atomic
    ``os.replace`` (readers never see a torn entry; the last complete
    write wins), staleness is judged by file mtime, and corrupt entries
    are deleted and counted, never raised.

    One file per replica (``hb-<name>.json``); :meth:`heartbeat`
    republishes it on a cadence (usually via :class:`Heartbeat`),
    :meth:`roster` reads the live view and surfaces join / stale /
    leave transitions as obs counters, :meth:`reap` garbage-collects
    entries that stayed stale past the reap threshold (a crashed
    replica's tombstone), and :meth:`retire` removes this replica's own
    entry for a clean leave (so the roster can tell shutdown from
    crash).

    >>> import tempfile
    >>> with tempfile.TemporaryDirectory() as d:
    ...     reg = FleetRegistry(d, name="p0")
    ...     _ = reg.heartbeat({"queue_depth": 0})
    ...     r = reg.roster()
    ...     (r["live"], r["replicas"][0]["name"])
    (1, 'p0')
    """

    def __init__(
        self,
        directory: str | Path,
        name: str | None = None,
        stale_after_s: float = 10.0,
        reap_after_s: float | None = None,
    ):
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.identity = replica_identity()
        self.name = name if name is not None else replica_name(self.identity)
        self.stale_after_s = float(stale_after_s)
        self.reap_after_s = (
            float(reap_after_s) if reap_after_s is not None
            else 3.0 * self.stale_after_s
        )
        self._seq = 0
        self._last_beat: float | None = None  # monotonic
        self._lock = threading.Lock()
        # name -> "live" | "stale": the previous roster() view, so
        # transitions count exactly once per edge
        self._states: dict[str, str] = {}

    def _path(self, name: str) -> Path:
        safe = "".join(c if c.isalnum() or c in "-_." else "_" for c in name)
        return self.directory / f"hb-{safe}.json"

    # -- writer side ---------------------------------------------------

    def heartbeat(self, payload: Mapping | None = None) -> str:
        """Atomically (re)publish this replica's entry. ``payload`` is
        the replica's self-reported state (queue depth, in-flight
        batch, SLO alerts, scrape URL, ...) and rides verbatim under
        ``"payload"``. Returns the entry path."""
        with self._lock:
            self._seq += 1
            seq = self._seq
            self._last_beat = time.monotonic()
        doc = {
            "name": self.name,
            "identity": self.identity,
            "seq": seq,
            "time_unix": time.time(),
            "payload": dict(payload) if payload else {},
        }
        target = self._path(self.name)
        tmp = target.with_name(
            f"{target.name}.{os.getpid()}.{uuid.uuid4().hex[:8]}.tmp"
        )
        try:
            with open(tmp, "w", encoding="utf-8") as fh:
                json.dump(doc, fh)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, target)
        except OSError:
            # a full/yanked shared volume must degrade observability,
            # never kill serving
            logger.warning("fleet: heartbeat write failed", exc_info=True)
            try:
                tmp.unlink(missing_ok=True)
            except OSError:
                pass
            _core.counter_add("fleet.heartbeat.errors")
            return str(target)
        _core.counter_add("fleet.heartbeats")
        return str(target)

    def last_heartbeat_age_s(self) -> float | None:
        """Seconds since THIS replica's last :meth:`heartbeat` (None
        before the first one) — the worker ``/healthz`` freshness
        field."""
        with self._lock:
            last = self._last_beat
        return None if last is None else time.monotonic() - last

    def retire(self) -> None:
        """Remove this replica's entry — a clean leave (vs. going
        stale, which is what a crash looks like)."""
        try:
            self._path(self.name).unlink(missing_ok=True)
        except OSError:
            pass

    # -- reader side ---------------------------------------------------

    def read(self) -> list[dict]:
        """Every parseable entry, with ``age_s`` (mtime-based) added.
        Corrupt files are deleted and counted, never raised — exactly
        the plan-cache contract."""
        out: list[dict] = []
        now = time.time()
        for path in sorted(self.directory.glob("hb-*.json")):
            try:
                with open(path, encoding="utf-8") as fh:
                    doc = json.load(fh)
                age = max(now - path.stat().st_mtime, 0.0)
            except (OSError, json.JSONDecodeError, UnicodeDecodeError):
                _core.counter_add("fleet.registry.corrupt_dropped")
                try:
                    path.unlink(missing_ok=True)
                except OSError:
                    pass
                continue
            if not isinstance(doc, dict):
                _core.counter_add("fleet.registry.corrupt_dropped")
                try:
                    path.unlink(missing_ok=True)
                except OSError:
                    pass
                continue
            doc["age_s"] = age
            doc.setdefault("name", path.stem[3:])
            out.append(doc)
        return out

    def roster(self) -> dict:
        """The live fleet view: one row per replica with its identity,
        heartbeat age, payload and ``state`` (``live`` when the entry's
        mtime is within ``stale_after_s``, else ``stale``). Join /
        went-stale / recovered / left transitions relative to the
        previous call are counted (``fleet.replica.*``) and the live /
        stale totals land as gauges — the autoscaler signal surface."""
        entries = self.read()
        rows = []
        states: dict[str, str] = {}
        for doc in entries:
            state = "live" if doc["age_s"] <= self.stale_after_s else "stale"
            states[doc["name"]] = state
            rows.append({
                "name": doc["name"],
                "state": state,
                "age_s": round(doc["age_s"], 3),
                "seq": doc.get("seq", 0),
                "identity": doc.get("identity", {}),
                "payload": doc.get("payload", {}),
            })
        transitions = {"joined": 0, "went_stale": 0, "recovered": 0,
                       "left": 0}
        with self._lock:
            prev = self._states
            for name, state in states.items():
                was = prev.get(name)
                if was is None:
                    transitions["joined"] += 1
                elif was == "live" and state == "stale":
                    transitions["went_stale"] += 1
                elif was == "stale" and state == "live":
                    transitions["recovered"] += 1
            for name in prev:
                if name not in states:
                    transitions["left"] += 1
            self._states = states
        for key, n in transitions.items():
            if n:
                _core.counter_add(f"fleet.replica.{key}", float(n))
        live = sum(1 for s in states.values() if s == "live")
        stale = len(states) - live
        _core.gauge_set("fleet.replicas.live", float(live))
        _core.gauge_set("fleet.replicas.stale", float(stale))
        return {
            "replicas": rows,
            "live": live,
            "stale": stale,
            "transitions": transitions,
        }

    def reap(self, reap_after_s: float | None = None) -> list[str]:
        """Delete entries whose mtime is older than ``reap_after_s``
        (default: the registry's, 3× the stale threshold). Returns the
        reaped names. A reaped replica that comes back simply
        re-joins on its next heartbeat."""
        threshold = (
            float(reap_after_s) if reap_after_s is not None
            else self.reap_after_s
        )
        now = time.time()
        reaped: list[str] = []
        for path in sorted(self.directory.glob("hb-*.json")):
            try:
                if now - path.stat().st_mtime <= threshold:
                    continue
                path.unlink()
            except OSError:
                continue
            name = path.stem[3:]
            reaped.append(name)
            with self._lock:
                self._states.pop(name, None)
        if reaped:
            _core.counter_add("fleet.replica.reaped", float(len(reaped)))
        return reaped


class Heartbeat:
    """Background heartbeat loop for one :class:`FleetRegistry` entry:
    publishes ``provider()`` every ``interval_s`` on a daemon thread
    until :meth:`stop` (which retires the entry — a clean leave — by
    default). Provider exceptions are swallowed and counted: a broken
    stats hook must degrade the heartbeat payload, not kill the
    cadence."""

    def __init__(
        self,
        registry: FleetRegistry,
        provider: Callable[[], Mapping] | None = None,
        interval_s: float = 2.0,
    ):
        self.registry = registry
        self.provider = provider
        self.interval_s = float(interval_s)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def _payload(self) -> dict:
        if self.provider is None:
            return {}
        try:
            return dict(self.provider())
        except Exception:  # noqa: BLE001 — keep the cadence
            _core.counter_add("fleet.heartbeat.provider_errors")
            logger.warning("fleet: heartbeat provider failed", exc_info=True)
            return {}

    def _loop(self) -> None:
        while not self._stop.is_set():
            self.registry.heartbeat(self._payload())
            self._stop.wait(self.interval_s)

    def start(self) -> "Heartbeat":
        if self._thread is not None:
            return self
        self._stop.clear()
        self.registry.heartbeat(self._payload())  # join immediately
        self._thread = threading.Thread(
            target=self._loop, name="tnc-fleet-heartbeat", daemon=True
        )
        self._thread.start()
        return self

    def stop(self, retire: bool = True) -> None:
        thread, self._thread = self._thread, None
        if thread is None:
            return
        self._stop.set()
        thread.join(timeout=self.interval_s + 5.0)
        if retire:
            self.registry.retire()

    def __enter__(self) -> "Heartbeat":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


# -- federated telemetry ------------------------------------------------


def _series_family(series: str) -> str:
    return series.split("{", 1)[0]


def _series_without_replica(series: str) -> str:
    """Drop a ``replica="..."`` label from a rendered series key —
    counters sum across replicas per family+labels, so the source
    replica's identity (baked in by a worker's ``base_labels``) must
    not keep the series apart."""
    i = series.find('replica="')
    if i < 0:
        return series
    j = series.index('"', i + len('replica="')) + 1
    if series[j: j + 1] == ",":
        j += 1  # replica="x",rest  ->  rest
    elif series[i - 1: i] == ",":
        i -= 1  # head,replica="x"}  ->  head}
    out = series[:i] + series[j:]
    return out[:-2] if out.endswith("{}") else out


def _series_with_replica(series: str, replica: str) -> str:
    """Inject a ``replica="<name>"`` label into a rendered series key
    (idempotent: a series that already carries one — a worker endpoint
    labeled at the source — is returned unchanged)."""
    if 'replica="' in series:
        return series
    from tnc_tpu_torch.obs.http import escape_label_value

    label = f'replica="{escape_label_value(replica)}"'
    if series.endswith("}"):
        head, _, rest = series.partition("{")
        return f"{head}{{{label},{rest}"
    return f"{series}{{{label}}}"


def merge_fleet_metrics(
    per_replica: Mapping[str, Mapping[str, float]],
    types: Mapping[str, str] | None = None,
) -> dict:
    """Merge per-replica Prometheus snapshots into one fleet view.

    - **counters** (family type ``counter``) are summed across replicas
      in sorted replica order — deterministic, so the fleet total is
      bit-equal to summing the per-replica registries yourself;
    - **gauges and summaries** are kept per-replica, each series
      re-keyed with a ``replica=`` label (P² quantile sketches cannot
      be merged exactly, so no pooled percentile is fabricated);
    - quantile series additionally get a pooled **min/max envelope**
      per family+labels: the honest cross-fleet bound ("the p99 of
      every replica lies in [lo, hi]"), which is all the sketches
      actually support.

    ``types`` maps family name → Prometheus type (from the ``# TYPE``
    lines); series from typeless sources (heartbeat payloads) fall back
    to the ``_total`` suffix convention for counter detection.

    >>> merged = merge_fleet_metrics(
    ...     {"p0": {"x_total": 2.0, "g": 1.0},
    ...      "p1": {"x_total": 3.0, "g": 5.0}},
    ...     types={"x_total": "counter", "g": "gauge"})
    >>> merged["counters"]["x_total"]
    5.0
    >>> sorted(merged["per_replica"])
    ['g{replica="p0"}', 'g{replica="p1"}']
    """
    types = dict(types or {})
    counters: dict[str, float] = {}
    per_rep: dict[str, float] = {}
    envelope: dict[str, dict] = {}
    for replica in sorted(per_replica):
        series_map = per_replica[replica]
        for series in sorted(series_map):
            value = float(series_map[series])
            fam = _series_family(series)
            ftype = types.get(fam)
            if ftype is None:
                ftype = "counter" if fam.endswith("_total") else "gauge"
            if ftype == "counter":
                key = _series_without_replica(series)
                counters[key] = counters.get(key, 0.0) + value
                continue
            per_rep[_series_with_replica(series, replica)] = value
            if ftype == "summary" and 'quantile="' in series:
                env = envelope.setdefault(
                    series, {"min": value, "max": value, "replicas": 0}
                )
                env["min"] = min(env["min"], value)
                env["max"] = max(env["max"], value)
                env["replicas"] += 1
    return {
        "replicas": sorted(per_replica),
        "counters": counters,
        "per_replica": per_rep,
        "quantile_envelope": envelope,
    }


class FleetAggregator:
    """Root-side federation: one object that knows every replica's
    scrape source and produces the ``/fleet`` body.

    Sources, in precedence order per replica:

    - ``endpoints`` — ``{name: base_url}`` scraped over HTTP via
      ``parse_prometheus`` (each replica's live ``TelemetryServer``);
    - ``local`` — ``(name, callable() -> prometheus_text)`` for the
      process hosting the aggregator (no HTTP round-trip to yourself);
    - heartbeat payloads from ``registry`` — a replica whose payload
      carries ``"url"`` is scraped; one that instead carries a
      ``"counters"`` dict (no port open) contributes those directly.

    Scrape failures are counted and the replica is reported under
    ``"unreachable"`` — a dead replica must not take the fleet view
    down with it.
    """

    def __init__(
        self,
        endpoints: Mapping[str, str] | Iterable[str] = (),
        registry: FleetRegistry | None = None,
        local: tuple[str, Callable[[], str]] | None = None,
        timeout_s: float = 3.0,
    ):
        if isinstance(endpoints, Mapping):
            self.endpoints = dict(endpoints)
        else:
            self.endpoints = {
                f"replica{i}": str(url)
                for i, url in enumerate(endpoints)
            }
        self.registry = registry
        self.local = local
        self.timeout_s = float(timeout_s)

    @staticmethod
    def _fetch(url: str, timeout_s: float) -> str:
        import urllib.request

        if not url.endswith("/metrics"):
            url = url.rstrip("/") + "/metrics"
        with urllib.request.urlopen(url, timeout=timeout_s) as resp:
            return resp.read().decode("utf-8")

    def _sources(self, roster: dict | None) -> dict[str, dict]:
        """name -> {"url": ...} | {"text": ...} | {"values": ...}."""
        sources: dict[str, dict] = {}
        if roster is not None:
            for row in roster["replicas"]:
                payload = row.get("payload", {})
                if payload.get("url"):
                    sources[row["name"]] = {"url": str(payload["url"])}
                elif isinstance(payload.get("counters"), dict):
                    sources[row["name"]] = {
                        "values": {
                            str(k): float(v)
                            for k, v in payload["counters"].items()
                        }
                    }
        for name, url in self.endpoints.items():
            sources[name] = {"url": url}
        if self.local is not None:
            name, render = self.local
            sources[name] = {"render": render}
        return sources

    def snapshot(self) -> dict:
        """Scrape + merge everything into the ``/fleet`` JSON body."""
        from tnc_tpu_torch.obs.http import parse_prometheus, parse_prometheus_types

        roster = self.registry.roster() if self.registry is not None else None
        per_replica: dict[str, dict[str, float]] = {}
        types: dict[str, str] = {}
        unreachable: dict[str, str] = {}
        for name, src in sorted(self._sources(roster).items()):
            try:
                if "values" in src:
                    per_replica[name] = src["values"]
                    continue
                text = (
                    src["render"]() if "render" in src
                    else self._fetch(src["url"], self.timeout_s)
                )
                per_replica[name] = parse_prometheus(text)
                types.update(parse_prometheus_types(text))
            except Exception as exc:  # noqa: BLE001 — keep the fleet view up
                _core.counter_add("fleet.scrape.errors")
                unreachable[name] = f"{type(exc).__name__}: {exc}"
        merged = merge_fleet_metrics(per_replica, types)
        merged["unreachable"] = unreachable
        merged["note"] = (
            "counters are summed across replicas; gauges/quantiles are "
            "per-replica (P2 sketches do not merge exactly) with a "
            "pooled min/max envelope per quantile series"
        )
        if roster is not None:
            merged["roster"] = roster
        return merged


# -- crash flight recorder ----------------------------------------------

#: process-wide context stamped into every flight-recorder dump (the
#: ``context`` key): durable facts a postmortem needs that no span
#: carries — e.g. the cost-model generation that was pricing traffic at
#: crash time (``model_version``, set by the serving layer on adoption)
_flight_annotations: dict = {}
_flight_annotations_lock = threading.Lock()


def set_flight_annotation(**kwargs) -> None:
    """Merge key/value context into future flight-recorder dumps.
    Values must be JSON-serializable scalars; ``None`` deletes a key."""
    with _flight_annotations_lock:
        for key, value in kwargs.items():
            if value is None:
                _flight_annotations.pop(key, None)
            else:
                _flight_annotations[key] = value


def flight_annotations() -> dict:
    """The current annotation context (a copy)."""
    with _flight_annotations_lock:
        return dict(_flight_annotations)


class FlightRecorder:
    """Postmortem span ring: keeps the last ``capacity`` closed spans
    (read straight off the live obs registry — registry swaps are
    transparent) plus a counter/gauge snapshot, and dumps them
    atomically to ``<dir>/flight-<name>-<pid>.json``:

    - on a fatal exception (``sys.excepthook`` + ``threading
      .excepthook`` chains, original hooks still run),
    - on SIGTERM (handler chains to the previous one; the default
      disposition is re-delivered after the dump so termination
      semantics are preserved),
    - at interpreter exit, and
    - every ``flush_interval_s`` on a daemon thread — the reason a
      SIGKILL (uncatchable by definition) still leaves an artifact at
      most one interval stale.

    Arm it via ``TNC_TPU_FLIGHT_RECORDER=<dir>`` (see
    :func:`maybe_flight_recorder`, wired into ``obs.refresh_from_env``)
    or construct + :meth:`install` directly.
    """

    def __init__(
        self,
        directory: str | Path,
        capacity: int = 512,
        flush_interval_s: float = 1.0,
        name: str | None = None,
    ):
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.capacity = int(capacity)
        self.flush_interval_s = float(flush_interval_s)
        self.identity = replica_identity()
        self.name = name if name is not None else replica_name(self.identity)
        self.path = self.directory / (
            f"flight-{self.name}-{os.getpid()}.json"
        )
        self._lock = threading.Lock()
        self._dumps = 0
        self._last_fingerprint: tuple | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._prev_excepthook = None
        self._prev_threading_hook = None
        self._prev_sigterm = None
        self._installed = False

    # -- dumping -------------------------------------------------------

    def _spans(self) -> list[dict]:
        reg = get_registry()
        recs = reg.recent_spans(self.capacity, include_open=True)
        return [
            {
                "name": r.name,
                "start_s": r.start_ns / 1e9,
                "dur_s": r.dur_ns / 1e9,
                "pid": r.pid,
                "tid": r.tid,
                "depth": r.depth,
                "args": {
                    k: v if isinstance(v, (str, int, float, bool, type(None)))
                    else str(v)
                    for k, v in r.args.items()
                },
            }
            for r in recs
        ]

    def dump(self, reason: str) -> str | None:
        """Write the ring + metric snapshot atomically (unique tmp +
        ``os.replace`` — a dump racing a SIGKILL leaves either the
        previous complete file or the new one, never a torn one).
        Never raises. Returns the path, or None on failure."""
        reg = get_registry()
        try:
            with self._lock:
                self._dumps += 1
                doc = {
                    "reason": reason,
                    "written_unix": time.time(),
                    "replica": self.identity,
                    "name": self.name,
                    "dumps": self._dumps,
                    "spans": self._spans(),
                    "counters": {
                        _core.format_metric_key(k): v
                        for k, v in reg.counters().items()
                    },
                    "gauges": {
                        _core.format_metric_key(k): v
                        for k, v in reg.gauges().items()
                    },
                    "dropped_spans": reg.dropped_spans(),
                    "context": flight_annotations(),
                }
                tmp = self.path.with_name(
                    f"{self.path.name}.{os.getpid()}."
                    f"{uuid.uuid4().hex[:8]}.tmp"
                )
                with open(tmp, "w", encoding="utf-8") as fh:
                    json.dump(doc, fh)
                    fh.flush()
                    os.fsync(fh.fileno())
                os.replace(tmp, self.path)
            return str(self.path)
        except Exception:  # noqa: BLE001 — a recorder must never crash its host
            logger.warning("fleet: flight-recorder dump failed",
                           exc_info=True)
            return None

    def _flush_loop(self) -> None:
        while not self._stop.wait(self.flush_interval_s):
            reg = get_registry()
            fp = (id(reg), len(reg.recent_spans(1)) and
                  reg.recent_spans(1)[-1].start_ns,
                  reg.dropped_spans())
            if fp != self._last_fingerprint:
                self._last_fingerprint = fp
                self.dump("periodic")

    # -- hooks ---------------------------------------------------------

    def _on_exception(self, exc_type, exc, tb) -> None:
        self.dump(f"exception:{exc_type.__name__}")
        if self._prev_excepthook is not None:
            self._prev_excepthook(exc_type, exc, tb)

    def _on_thread_exception(self, hook_args) -> None:
        et = hook_args.exc_type.__name__ if hook_args.exc_type else "?"
        self.dump(f"thread-exception:{et}")
        if self._prev_threading_hook is not None:
            self._prev_threading_hook(hook_args)

    def _on_sigterm(self, signum, frame) -> None:
        self.dump("sigterm")
        prev = self._prev_sigterm
        if callable(prev):
            prev(signum, frame)
            return
        if prev == signal.SIG_IGN:
            return
        # default disposition: restore it and re-deliver, so the
        # process still dies of SIGTERM exactly as unrecorded code would
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        os.kill(os.getpid(), signal.SIGTERM)

    def install(self) -> "FlightRecorder":
        """Arm every dump trigger (idempotent). Safe off the main
        thread — the SIGTERM hook is simply skipped there."""
        if self._installed:
            return self
        self._installed = True
        self._prev_excepthook = sys.excepthook
        sys.excepthook = self._on_exception
        self._prev_threading_hook = threading.excepthook
        threading.excepthook = self._on_thread_exception
        try:
            self._prev_sigterm = signal.signal(
                signal.SIGTERM, self._on_sigterm
            )
        except (ValueError, OSError):  # not the main thread
            self._prev_sigterm = None
        import atexit

        atexit.register(self._atexit)
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._flush_loop, name="tnc-flight-recorder", daemon=True
        )
        self._thread.start()
        self.dump("armed")
        return self

    def _atexit(self) -> None:
        self._stop.set()
        self.dump("atexit")

    def uninstall(self) -> None:
        """Disarm (tests): stop the flush thread and restore hooks."""
        if not self._installed:
            return
        self._installed = False
        import atexit

        atexit.unregister(self._atexit)
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=self.flush_interval_s + 5.0)
        if sys.excepthook == self._on_exception:
            sys.excepthook = self._prev_excepthook or sys.__excepthook__
        if threading.excepthook == self._on_thread_exception:
            threading.excepthook = (
                self._prev_threading_hook or threading.__excepthook__
            )
        if self._prev_sigterm is not None:
            try:
                signal.signal(signal.SIGTERM, self._prev_sigterm)
            except (ValueError, OSError):
                pass


_FLIGHT: FlightRecorder | None = None
_FLIGHT_LOCK = threading.Lock()


def flight_recorder() -> FlightRecorder | None:
    """The armed process-wide recorder, if any."""
    return _FLIGHT


def maybe_flight_recorder() -> FlightRecorder | None:
    """Arm (once) the process-wide :class:`FlightRecorder` when
    ``TNC_TPU_FLIGHT_RECORDER`` names a directory; called from
    ``obs.refresh_from_env`` so setting the env var is the whole
    deployment story. ``TNC_TPU_FLIGHT_INTERVAL`` overrides the
    periodic-flush cadence (seconds)."""
    global _FLIGHT
    directory = os.environ.get("TNC_TPU_FLIGHT_RECORDER", "").strip()
    if not directory:
        return _FLIGHT
    with _FLIGHT_LOCK:
        if _FLIGHT is not None and str(_FLIGHT.directory) == directory:
            return _FLIGHT
        try:
            interval = float(
                os.environ.get("TNC_TPU_FLIGHT_INTERVAL", "1.0")
            )
        except ValueError:
            interval = 1.0
        try:
            _FLIGHT = FlightRecorder(
                directory, flush_interval_s=interval
            ).install()
        except OSError:
            logger.warning(
                "fleet: could not arm flight recorder at %s", directory,
                exc_info=True,
            )
            return None
    return _FLIGHT
