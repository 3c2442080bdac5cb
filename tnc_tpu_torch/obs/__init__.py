"""tnc_tpu_torch.obs — env-gated step spans and the calibrated cost model
(the port's counterpart of ``tnc_tpu.obs``, its span registry and
``calibrate`` module).

``TNC_TPU_TRACE`` gates recording: unset → every span is a near-zero-cost
no-op; set → spans record in-process. ``TNC_TPU_STEP_TIME`` additionally
makes :class:`~tnc_tpu_torch.ops.backends.TorchBackend` run programs one
synchronised launch unit at a time, so its step spans carry measured times
that :func:`~tnc_tpu_torch.obs.calibrate.fit_device_model` fits.
"""

from tnc_tpu_torch.obs.core import (  # noqa: F401
    NULL_SPAN,
    MetricsRegistry,
    Span,
    SpanRecord,
    configure,
    enabled,
    get_registry,
    refresh_from_env,
    reset,
    span,
    step_timing_enabled,
)
from tnc_tpu_torch.obs.calibrate import (  # noqa: F401
    CalibratedCostModel,
    DeviceModel,
    StepSample,
    calibration_report,
    fit_device_model,
    step_samples,
)
