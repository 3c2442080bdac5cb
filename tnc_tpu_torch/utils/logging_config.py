"""Library-wide structured logging and the platform pin (the port's copy
of ``tnc_tpu.utils.logging_config``).

Every module of the port logs through the std :mod:`logging` hierarchy
under ``__name__``, so under the ``tnc_tpu_torch`` logger; by default
records propagate to whatever handlers the application configured.

``TNC_TPU_LOG=<level>`` (debug/info/warning/...) attaches a stderr
handler to the ``tnc_tpu_torch`` logger at import time — the zero-setup
way to watch the pipeline stages of a run.

``TNC_TPU_PLATFORM=cpu`` asks for the host: with it, ``device=None``
means the CPU in :func:`tnc_tpu_torch.ops.backends.resolve_device`, so
``TorchBackend()`` and ``get_backend("torch")`` run there. ``cuda`` or
``gpu``, or the variable unset, means the card. The pin is a module
variable that ``resolve_device`` reads; setting it imports no torch.
"""

from __future__ import annotations

import logging
import os

_FORMAT = "%(asctime)s %(levelname)s %(name)s: %(message)s"

#: the ``TNC_TPU_PLATFORM`` words and the device type each pins
PLATFORMS = {"cpu": "cpu", "cuda": "cuda", "gpu": "cuda"}

#: the device type ``device=None`` means: ``"cuda"`` unless pinned
_PINNED: str | None = None


def pinned_device() -> str:
    """The device type an entry point given ``device=None`` runs on:
    ``"cpu"`` under ``TNC_TPU_PLATFORM=cpu``, else ``"cuda"``.

    >>> pinned_device() in ("cpu", "cuda")
    True
    """
    return _PINNED or "cuda"


def pin_platform_from_env() -> None:
    """Honor ``TNC_TPU_PLATFORM=<cpu|cuda|gpu>`` at package import: pin
    the device that ``device=None`` means. An unknown value logs a warning
    and changes nothing; an unset or empty one leaves the pin as it is.

    >>> import os
    >>> os.environ.pop("TNC_TPU_PLATFORM", None) and None
    >>> pin_platform_from_env()   # unset: nothing pinned, no error
    """
    global _PINNED
    platform = os.environ.get("TNC_TPU_PLATFORM")
    if not platform:
        return
    device = PLATFORMS.get(platform.strip().lower())
    if device is None:
        logging.getLogger("tnc_tpu_torch").warning(
            "could not pin platform %r (one of %s)", platform, ", ".join(PLATFORMS)
        )
        return
    _PINNED = device


def configure_from_env() -> None:
    """Attach a stderr handler at ``TNC_TPU_LOG``'s level, if set.

    >>> import os
    >>> os.environ.pop("TNC_TPU_LOG", None) and None
    >>> configure_from_env()   # unset: no handler attached, no error
    """
    level_name = os.environ.get("TNC_TPU_LOG")
    if not level_name:
        return
    level = getattr(logging, level_name.upper(), None)
    if not isinstance(level, int):
        return
    root = logging.getLogger("tnc_tpu_torch")
    if any(getattr(h, "_tnc_tpu_env", False) for h in root.handlers):
        return
    handler = logging.StreamHandler()
    handler.setFormatter(logging.Formatter(_FORMAT))
    handler._tnc_tpu_env = True  # type: ignore[attr-defined]
    root.addHandler(handler)
    root.setLevel(level)
