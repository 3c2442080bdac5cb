"""Live telemetry endpoint: Prometheus ``/metrics`` + ``/healthz`` +
``/slo`` over the stdlib HTTP server (the port's copy of
``tnc_tpu.obs.http``).

The obs registry answers "what happened" in-process; this module makes
the answer scrapeable while the process serves. Design constraints:

- **stdlib only** (``http.server`` on a daemon thread) — a serving
  replica must not grow a web-framework dependency;
- **deterministic text**: families sorted by name, series sorted by
  label set, one ``# TYPE`` line per family — two scrapes of the same
  state are byte-identical, and the rendering is testable as a string;
- **correct escaping**: label values escape ``\\``, ``"`` and newlines
  per the Prometheus text exposition format (v0.0.4);
- **provider hooks**, not imports: the server takes callables for
  health / SLO / extra metric families, so ``tnc_tpu_torch.serve`` wires a
  live :class:`~tnc_tpu_torch.serve.service.ContractionService` in without
  this module importing the serving layer.

Registry histograms render as Prometheus *summaries* (quantile series +
``_count`` + ``_sum``) straight off the same
:class:`~tnc_tpu_torch.obs.core.QuantileSummary` objects ``stats()`` reads —
identical percentiles on both surfaces by construction.

>>> from tnc_tpu_torch.obs.core import MetricsRegistry
>>> reg = MetricsRegistry()
>>> reg.counter_add("serve.requests", 3, outcome="completed")
>>> text = render_prometheus(reg)
>>> print(text.splitlines()[0])
# TYPE tnc_tpu_serve_requests_total counter
>>> print(text.splitlines()[1])
tnc_tpu_serve_requests_total{outcome="completed"} 3.0
"""

from __future__ import annotations

import http.server
import json
import logging
import re
import socket
import threading
from typing import Callable, Iterable

from tnc_tpu_torch.obs.core import MetricsRegistry, get_registry

logger = logging.getLogger(__name__)

_NAME_BAD = re.compile(r"[^a-zA-Z0-9_:]")
_PREFIX = "tnc_tpu_"

#: an extra metric sample a provider hands the renderer:
#: ``(family_type, family_name, labels_dict, value)`` with
#: ``family_type`` in {"counter", "gauge", "summary"}
Sample = tuple


def metric_name(name: str, prefix: str = _PREFIX) -> str:
    """Registry metric name → Prometheus family name (dots become
    underscores, everything namespaced under ``tnc_tpu_``).

    >>> metric_name("serve.plan_cache.hit")
    'tnc_tpu_serve_plan_cache_hit'
    """
    name = _NAME_BAD.sub("_", name)
    if not name.startswith(prefix):
        name = prefix + name
    if name[0].isdigit():  # family names may not start with a digit
        name = "_" + name
    return name


def escape_label_value(value) -> str:
    """Prometheus text-format label escaping: backslash, double quote,
    newline.

    >>> escape_label_value('a"b\\\\c\\nd')
    'a\\\\"b\\\\\\\\c\\\\nd'
    """
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def format_labels(labels) -> str:
    """Sorted, escaped ``{k="v",...}`` label block ('' when empty).
    Accepts a dict or the registry's ``((k, v), ...)`` tuple form."""
    items = sorted(dict(labels).items()) if labels else []
    if not items:
        return ""
    inner = ",".join(
        f'{_NAME_BAD.sub("_", str(k))}="{escape_label_value(v)}"'
        for k, v in items
    )
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    return repr(float(v))


def render_prometheus(
    registry: MetricsRegistry | None = None,
    extra: Iterable[Sample] = (),
    base_labels: dict | None = None,
) -> str:
    """Render a registry (+ provider samples) as Prometheus text
    exposition format v0.0.4. Counters gain the conventional ``_total``
    suffix; histograms render as summaries with ``quantile`` series.
    Output ordering is deterministic: families by name, series by label
    block. ``base_labels`` are merged into EVERY series (series labels
    win) — how a fleet replica stamps ``replica=`` onto its whole
    endpoint."""
    reg = registry if registry is not None else get_registry()
    # family name -> (type, {label_block: value}); keyed by label block
    # so a provider sample OVERRIDES a registry series with the same
    # family + labels (e.g. the service's live queue-depth gauge vs the
    # traced `serve.queue_depth` gauge) instead of emitting a duplicate
    # sample, which a Prometheus server rejects as a parse error
    families: dict[str, tuple[str, dict[str, float]]] = {}

    def add(ftype: str, fname: str, labels, value: float) -> None:
        if base_labels:
            labels = {**base_labels, **dict(labels or {})}
        fam = families.setdefault(fname, (ftype, {}))
        if fam[0] != ftype:
            # same family name claimed by two metric types: keep the
            # first, suffix the newcomer so the exposition stays valid
            return add(ftype, f"{fname}_{ftype}", labels, value)
        fam[1][format_labels(labels)] = float(value)

    for (name, labels), value in reg.counters().items():
        add("counter", metric_name(name) + "_total", labels, value)
    for (name, labels), value in reg.gauges().items():
        add("gauge", metric_name(name), labels, value)
    # histograms() snapshots each summary UNDER the registry lock, so a
    # scrape mid-observe still renders an internally consistent block
    for (name, labels), snap in reg.histograms().items():
        fname = metric_name(name)
        base = dict(labels)
        for key, v in snap.items():
            if key.startswith("p"):  # p50 / p90 / p99 / p99_9 ...
                q = float(key[1:].replace("_", ".")) / 100.0
                add("summary", fname, {**base, "quantile": f"{q:g}"}, v)
        add("summary", fname + "_count", base, snap["count"])
        add("summary", fname + "_sum", base, snap["sum"])
    for ftype, fname, labels, value in extra:
        fname = metric_name(str(fname))
        # provider counters get the same conventional suffix as
        # registry counters — one naming rule on the whole endpoint
        if ftype == "counter" and not fname.endswith("_total"):
            fname += "_total"
        add(str(ftype), fname, labels, value)

    lines: list[str] = []
    for fname in sorted(families):
        ftype, series = families[fname]
        # summary auxiliary series (_count/_sum) ride their parent's
        # TYPE line in real exporters; standalone is simplest and valid
        lines.append(f"# TYPE {fname} {ftype}")
        for label_block, value in sorted(series.items()):
            lines.append(f"{fname}{label_block} {_fmt_value(value)}")
    return "\n".join(lines) + "\n"


def parse_prometheus(text: str) -> dict[str, float]:
    """Inverse of :func:`render_prometheus` for tests and the ops CLI:
    ``{'name{label="v"}': value}`` (comment lines skipped).

    >>> parse_prometheus('# TYPE a counter\\na{x="1"} 2.0\\n')
    {'a{x="1"}': 2.0}
    """
    out: dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        key, _, value = line.rpartition(" ")
        try:
            out[key] = float(value)
        except ValueError:
            continue
    return out


def parse_prometheus_types(text: str) -> dict[str, str]:
    """Family-name → type map from the ``# TYPE`` lines — the half of
    the exposition :func:`parse_prometheus` drops, needed by the fleet
    aggregator to tell summed-across-replicas counters from
    kept-per-replica gauges/summaries.

    >>> parse_prometheus_types('# TYPE a counter\\na 1.0\\n')
    {'a': 'counter'}
    """
    out: dict[str, str] = {}
    for line in text.splitlines():
        parts = line.strip().split()
        if len(parts) == 4 and parts[0] == "#" and parts[1] == "TYPE":
            out[parts[2]] = parts[3]
    return out


class _Handler(http.server.BaseHTTPRequestHandler):
    server_version = "tnc-tpu-telemetry/1.0"
    protocol_version = "HTTP/1.1"

    def do_GET(self) -> None:  # noqa: N802 — stdlib naming
        srv: "TelemetryServer" = self.server.telemetry  # type: ignore[attr-defined]
        path = self.path.split("?", 1)[0]
        try:
            if path == "/metrics":
                body = srv.render_metrics().encode("utf-8")
                ctype = "text/plain; version=0.0.4; charset=utf-8"
                status = 200
            elif path == "/healthz":
                health = srv.health()
                body = json.dumps(health).encode("utf-8")
                ctype = "application/json"
                status = 200 if health.get("status") == "ok" else 503
            elif path == "/slo":
                body = json.dumps(srv.slo()).encode("utf-8")
                ctype = "application/json"
                status = 200
            elif path == "/fleet":
                body = json.dumps(srv.fleet()).encode("utf-8")
                ctype = "application/json"
                status = 200
            elif path == "/calibration":
                body = json.dumps(srv.calibration()).encode("utf-8")
                ctype = "application/json"
                status = 200
            else:
                body = b'{"error": "not found"}'
                ctype = "application/json"
                status = 404
        except Exception as exc:  # noqa: BLE001 — a scrape must not kill serving
            logger.exception("telemetry handler failed for %s", path)
            body = json.dumps({"error": str(exc)}).encode("utf-8")
            ctype = "application/json"
            status = 500
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt: str, *args) -> None:  # silence stderr
        logger.debug("telemetry: " + fmt, *args)


class TelemetryServer:
    """Own one scrape endpoint for a serving process.

    ``port=0`` binds an ephemeral port (read it back from ``.port``
    after :meth:`start`). Provider hooks:

    - ``extra_metrics_fn() -> iterable[Sample]`` — service-level
      families merged into ``/metrics`` next to the obs registry;
    - ``health_fn() -> dict`` — the ``/healthz`` body (``status`` key;
      anything but ``"ok"`` answers 503);
    - ``slo_fn() -> dict`` — the ``/slo`` JSON body;
    - ``fleet_fn() -> dict`` — the ``/fleet`` JSON body (the federated
      cross-replica view, :class:`~tnc_tpu_torch.obs.fleet.
      FleetAggregator`; without a provider the route answers
      ``{"enabled": false}``);
    - ``calibration_fn() -> dict`` — the ``/calibration`` JSON body
      (the cost-truth loop's state: live model generation, sampler
      fill, refit ledger, plan scoreboard; see
      :mod:`tnc_tpu_torch.obs.cost_truth`).

    ``base_labels`` stamps every ``/metrics`` series (fleet replicas
    pass ``{"replica": "p<idx>"}`` so scrapes stay distinguishable
    after federation).

    :meth:`stop` shuts the listener down and **releases the port**
    (pinned by ``tests/test_slo.py::test_endpoint_port_release``).

    >>> srv = TelemetryServer(registry=MetricsRegistry()).start()
    >>> import urllib.request
    >>> with urllib.request.urlopen(srv.url + "/healthz", timeout=5) as r:
    ...     json.load(r)["status"]
    'ok'
    >>> srv.stop()
    """

    def __init__(
        self,
        registry: MetricsRegistry | None = None,
        host: str = "127.0.0.1",
        port: int = 0,
        health_fn: Callable[[], dict] | None = None,
        slo_fn: Callable[[], dict] | None = None,
        extra_metrics_fn: Callable[[], Iterable[Sample]] | None = None,
        fleet_fn: Callable[[], dict] | None = None,
        base_labels: dict | None = None,
        calibration_fn: Callable[[], dict] | None = None,
    ):
        self.registry = registry
        self.host = host
        self._requested_port = int(port)
        self.health_fn = health_fn
        self.slo_fn = slo_fn
        self.extra_metrics_fn = extra_metrics_fn
        self.fleet_fn = fleet_fn
        self.calibration_fn = calibration_fn
        self.base_labels = dict(base_labels) if base_labels else None
        self._httpd: http.server.ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    # -- provider plumbing ----------------------------------------------

    def render_metrics(self) -> str:
        extra = list(self.extra_metrics_fn()) if self.extra_metrics_fn else []
        return render_prometheus(
            self.registry if self.registry is not None else get_registry(),
            extra,
            base_labels=self.base_labels,
        )

    def health(self) -> dict:
        return self.health_fn() if self.health_fn else {"status": "ok"}

    def slo(self) -> dict:
        return self.slo_fn() if self.slo_fn else {}

    def fleet(self) -> dict:
        return self.fleet_fn() if self.fleet_fn else {"enabled": False}

    def calibration(self) -> dict:
        return (
            self.calibration_fn() if self.calibration_fn
            else {"enabled": False}
        )

    # -- lifecycle -------------------------------------------------------

    @property
    def port(self) -> int:
        return (
            self._httpd.server_address[1]
            if self._httpd is not None
            else self._requested_port
        )

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "TelemetryServer":
        if self._httpd is not None:
            return self
        httpd = http.server.ThreadingHTTPServer(
            (self.host, self._requested_port), _Handler
        )
        httpd.telemetry = self  # type: ignore[attr-defined]
        httpd.daemon_threads = True
        self._httpd = httpd
        self._thread = threading.Thread(
            target=httpd.serve_forever,
            name="tnc-telemetry",
            daemon=True,
            kwargs={"poll_interval": 0.1},
        )
        self._thread.start()
        logger.info("telemetry endpoint listening on %s", self.url)
        return self

    def stop(self) -> None:
        """Stop serving and release the port (idempotent)."""
        httpd, self._httpd = self._httpd, None
        thread, self._thread = self._thread, None
        if httpd is None:
            return
        httpd.shutdown()
        # server_close() releases the listening socket; SO_REUSEADDR on
        # the stdlib server means the port is immediately rebindable
        httpd.server_close()
        if thread is not None:
            thread.join(timeout=10.0)

    def __enter__(self) -> "TelemetryServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def wait_port_released(host: str, port: int, timeout_s: float = 5.0) -> bool:
    """True once nothing accepts connections on ``host:port`` (the
    endpoint-lifecycle test's probe)."""
    import time as _time

    deadline = _time.monotonic() + timeout_s
    while _time.monotonic() < deadline:
        try:
            with socket.create_connection((host, port), timeout=0.2):
                pass
        except OSError:
            return True
        _time.sleep(0.05)
    return False
