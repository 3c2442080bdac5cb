"""Structured JSON logging, one file per process (the port's copy of
``tnc_tpu.benchmark.logging_util``).

JSON records, a log file discriminated per process, Info+ duplicated to
stderr. The discriminant comes from
:func:`tnc_tpu_torch.obs.core.process_identity`: ``proc{rank}`` when a
``torch.distributed`` group of several processes is up, else
``pid{pid}``.

Contract (matching ``utils/logging_config.py``): :func:`setup_logging`
is **idempotent and additive** — calling it twice attaches nothing
twice, and handlers the application installed on the ``tnc_tpu_torch``
logger are left alone (records keep flowing to them).
:class:`JsonFormatter` serializes ``extra=`` structured fields, so metric
records land in the JSONL sink with their payload intact.

>>> import json, logging
>>> rec = logging.LogRecord("tnc_tpu_torch.x", logging.INFO, "", 0, "hi %d", (3,), None)
>>> rec.cell = "a"
>>> out = json.loads(JsonFormatter().format(rec))
>>> out["level"], out["msg"], out["cell"]
('INFO', 'hi 3', 'a')
"""

from __future__ import annotations

import json
import logging
import os
import sys
from pathlib import Path

# Attributes every LogRecord carries (plus formatter-injected ones);
# anything else on a record came in via ``extra=`` and belongs in the
# JSON payload.
_RESERVED = set(
    logging.LogRecord("", 0, "", 0, "", (), None).__dict__
) | {"message", "asctime", "taskName"}


class JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        payload = {
            "ts": self.formatTime(record),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        for key, value in record.__dict__.items():
            if key in _RESERVED or key.startswith("_") or key in payload:
                continue
            payload[key] = value
        if record.exc_info:
            payload["exc"] = self.formatException(record.exc_info)
        return json.dumps(payload, default=str)


def process_discriminant() -> str:
    """``proc{rank}`` in a ``torch.distributed`` group of several
    processes, else ``pid{pid}``.

    >>> process_discriminant() == f"pid{os.getpid()}"
    True
    """
    from tnc_tpu_torch.obs.core import process_identity

    count, index = process_identity()
    return f"proc{index}" if count > 1 else f"pid{os.getpid()}"


def setup_logging(log_dir: str | Path | None = None, level=logging.INFO) -> None:
    """Configure the ``tnc_tpu_torch`` logger tree: JSON file per process
    plus human-readable stderr. Idempotent (re-runs replace only the
    handlers this function installed) and additive (application handlers
    stay)."""
    root = logging.getLogger("tnc_tpu_torch")
    root.setLevel(level)
    # replace only LIBRARY-installed handlers: this function's own
    # (_tnc_tpu_bench) and the TNC_TPU_LOG import-time stderr handler
    # (_tnc_tpu_env, utils/logging_config.py) — the latter would
    # duplicate every record on stderr next to the one installed below.
    # Application handlers are left alone.
    for handler in [
        h for h in root.handlers
        if getattr(h, "_tnc_tpu_bench", False)
        or getattr(h, "_tnc_tpu_env", False)
    ]:
        root.removeHandler(handler)
        handler.close()

    stream = logging.StreamHandler(sys.stderr)
    stream.setFormatter(
        logging.Formatter("[%(asctime)s %(levelname)s %(name)s] %(message)s")
    )
    stream._tnc_tpu_bench = True  # type: ignore[attr-defined]
    root.addHandler(stream)

    if log_dir is not None:
        path = Path(log_dir)
        path.mkdir(parents=True, exist_ok=True)
        fh = logging.FileHandler(path / f"benchmark_{process_discriminant()}.jsonl")
        fh.setFormatter(JsonFormatter())
        fh._tnc_tpu_bench = True  # type: ignore[attr-defined]
        root.addHandler(fh)
