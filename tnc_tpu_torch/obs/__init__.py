"""tnc_tpu_torch.obs — env-gated spans and metrics and the calibrated cost
model (the port's counterpart of ``tnc_tpu.obs``: its ``core`` registry of
spans, counters, gauges and histograms, and its ``calibrate`` module).

``TNC_TPU_TRACE`` gates recording: unset → every span is a near-zero-cost
no-op; set → spans record in-process. ``TNC_TPU_STEP_TIME`` additionally
makes :class:`~tnc_tpu_torch.ops.backends.TorchBackend` run programs one
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
    observe,
    refresh_from_env,
    reset,
    span,
    step_timing_enabled,
    trace_args,
    traced,
)
from tnc_tpu_torch.obs.calibrate import (  # noqa: F401
    CalibratedCostModel,
    DeviceModel,
    StepSample,
    calibration_report,
    fit_device_model,
    step_samples,
)
