"""tnc_tpu_torch.obs — env-gated spans and metrics, their exporters, the
calibrated cost model and the serving planes that read them (the port's
counterpart of ``tnc_tpu.obs``: ``core``, ``export``, ``http``,
``calibrate``, ``slo``, ``cost_truth`` and ``fleet``).

``TNC_TPU_TRACE`` gates recording: unset → every span is a near-zero-cost
no-op; ``1`` → spans and counters record in-process; a path → they also
export as a Chrome-trace/Perfetto timeline at interpreter exit.
``TNC_TPU_STEP_TIME`` additionally makes
:class:`~tnc_tpu_torch.ops.backends.TorchBackend` run programs one
synchronised launch unit at a time, so its step spans carry measured times
that :func:`~tnc_tpu_torch.obs.calibrate.fit_device_model` fits.
"""

from tnc_tpu_torch.obs.core import (  # noqa: F401
    NULL_SPAN,
    MetricsRegistry,
    QuantileSummary,
    Span,
    SpanRecord,
    configure,
    counter_add,
    counters_by_prefix,
    enabled,
    format_metric_key,
    gauge_set,
    get_registry,
    maybe_jax_profiler_trace,
    observe,
    process_trace_path,
    refresh_from_env,
    reset,
    span,
    step_timing_enabled,
    trace_args,
    trace_path,
    traced,
)
from tnc_tpu_torch.obs.export import (  # noqa: F401
    chrome_trace_events,
    emit_metrics,
    export_chrome_trace,
    export_jsonl,
    format_serve_rollup,
    format_summary_table,
    load_trace_events,
    merge_trace_files,
    serve_trace_rollup,
    trace_summary,
)
from tnc_tpu_torch.obs.calibrate import (  # noqa: F401
    CalibratedCostModel,
    DeviceModel,
    StepSample,
    calibration_report,
    fit_device_model,
    step_samples,
)
from tnc_tpu_torch.obs.slo import (  # noqa: F401
    BurnWindow,
    DriftDetector,
    LatencyObjective,
    SLOConfig,
    SLOEngine,
)
from tnc_tpu_torch.obs.cost_truth import (  # noqa: F401
    CostTruth,
    CostTruthConfig,
    ModelRegistry,
    ModelRegistryWatcher,
    PlanScoreboard,
    ProductionSampler,
    refit_model,
)

# the HTTP endpoint layer re-exports lazily (PEP 562), as the reference's
# does: only telemetry-serving processes pay the http.server import
_HTTP_EXPORTS = (
    "TelemetryServer",
    "parse_prometheus",
    "parse_prometheus_types",
    "render_prometheus",
)

# the fleet plane (cross-host trace propagation, replica registry,
# federation, flight recorder) re-exports lazily for the same reason
_FLEET_EXPORTS = (
    "FleetAggregator",
    "FleetRegistry",
    "FlightRecorder",
    "Heartbeat",
    "TraceContext",
    "adopt_trace_context",
    "current_dispatch_context",
    "dispatch_context",
    "flight_annotations",
    "flight_recorder",
    "maybe_flight_recorder",
    "merge_fleet_metrics",
    "replica_identity",
    "replica_name",
    "set_flight_annotation",
)


def __getattr__(name: str):
    if name in _HTTP_EXPORTS:
        from tnc_tpu_torch.obs import http as _http

        return getattr(_http, name)
    if name in _FLEET_EXPORTS:
        from tnc_tpu_torch.obs import fleet as _fleet

        return getattr(_fleet, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
