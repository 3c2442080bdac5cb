"""Deterministic fault injection at the execution-stack boundaries (the
port's copy of ``tnc_tpu.resilience.faultinject``).

Nothing in a CPU test suite can make CUDA run out of memory or a host be
preempted on demand, so every recovery path in
:mod:`tnc_tpu_torch.resilience` would otherwise be dead code until a real
card failed. This module plants named **fault points** at the boundaries
the retry/degrade machinery guards; a scripted spec makes chosen points
raise (or SIGKILL the process) a fixed number of times, deterministically.

Env-gated like :mod:`tnc_tpu_torch.obs`: with ``TNC_TPU_FAULTS`` unset,
:func:`fault_point` is one module-level bool check.

Spec DSL (``TNC_TPU_FAULTS`` or :func:`configure_faults`): rules
separated by ``;``, each

    site(key=value, ...) = kind * count

- ``site`` — the fault-point name. The port's sites: ``backend.dispatch``
  (one ``TorchBackend`` run), ``chunked.plan`` (a chunk plan is built),
  ``chunked.batch`` (``start=``, ``batch=``: one slice batch of the
  chunked executor), ``graphs.capture`` (``unit=``: inside a CUDA graph
  capture), ``sliced.slice`` (``s=``: one slice of the numpy oracle) and
  ``serve.dispatch`` (``kind=``, ``batch=``: one service batch).
- ``(key=value, ...)`` — optional match on the call-site context
  (compared as strings): ``chunked.batch(start=8)`` fires only for the
  batch starting at slice 8.
- ``kind`` — ``oom`` (raises with a ``RESOURCE_EXHAUSTED`` message →
  classified RESOURCE), ``transient``/``preempt`` (``UNAVAILABLE:
  injected preemption`` → TRANSIENT), ``fatal`` (``INTERNAL`` →
  FATAL), ``kill`` (SIGKILL the process — crash-resume runs), or
  ``slow[:seconds]`` (sleep instead of raise; default 0.05 s, e.g.
  ``serve.dispatch=slow:0.2*-1``).
- ``* count`` — how many times the rule fires (default 1; ``*-1`` =
  unlimited).

>>> with faults("demo.site(x=1)=oom*1"):
...     fault_point("demo.site", x=0)   # condition mismatch: no fire
...     try:
...         fault_point("demo.site", x=1)
...     except InjectedOOM as e:
...         print("fired:", "RESOURCE_EXHAUSTED" in str(e))
...     fault_point("demo.site", x=1)   # count exhausted: no fire
fired: True
>>> fault_point("demo.site", x=1)       # disabled outside the context
"""

from __future__ import annotations

import contextlib
import logging
import os
import signal
import threading
from dataclasses import dataclass

from tnc_tpu_torch import obs

logger = logging.getLogger(__name__)


class InjectedFault(RuntimeError):
    """Base class for injected failures (never raised itself)."""


class InjectedOOM(InjectedFault):
    """Classified RESOURCE by :func:`~tnc_tpu_torch.resilience.retry.classify_exception`."""


class InjectedTransient(InjectedFault):
    """Classified TRANSIENT — an injected preemption/disconnect."""


class InjectedFatal(InjectedFault):
    """Classified FATAL — an injected unrecoverable error."""


_KINDS = {
    "oom": (
        InjectedOOM,
        "RESOURCE_EXHAUSTED: injected out of memory at {site}",
    ),
    "transient": (
        InjectedTransient,
        "UNAVAILABLE: injected preemption at {site}",
    ),
    "preempt": (
        InjectedTransient,
        "UNAVAILABLE: injected preemption at {site}",
    ),
    "fatal": (
        InjectedFatal,
        "INTERNAL: injected fatal failure at {site}",
    ),
    "kill": (None, None),  # SIGKILL, no exception to raise
    "slow": (None, None),  # sleep, no exception — latency injection
}

_SLOW_DEFAULT_S = 0.05


@dataclass
class _Rule:
    site: str
    conds: dict[str, str]
    kind: str
    remaining: int  # -1 = unlimited
    arg: float = 0.0  # kind parameter (sleep seconds for ``slow``)


_RULES: list[_Rule] = []
_ENABLED = False
_LOCK = threading.Lock()


def parse_spec(spec: str) -> list[_Rule]:
    """Parse the DSL; raises ``ValueError`` on malformed rules so typos
    in ``TNC_TPU_FAULTS`` fail loudly instead of silently injecting
    nothing."""
    rules: list[_Rule] = []
    for raw in spec.split(";"):
        raw = raw.strip()
        if not raw:
            continue
        if "=" not in raw.split("(")[0] and "=" not in raw.rsplit(")", 1)[-1]:
            raise ValueError(f"fault rule missing '=kind': {raw!r}")
        # split 'site(conds)' from 'kind*count' at the LAST top-level '='
        depth = 0
        eq = -1
        for i, ch in enumerate(raw):
            if ch == "(":
                depth += 1
            elif ch == ")":
                depth -= 1
            elif ch == "=" and depth == 0:
                eq = i
        if eq < 0:
            raise ValueError(f"fault rule missing '=kind': {raw!r}")
        left, right = raw[:eq].strip(), raw[eq + 1:].strip()
        count = 1
        if "*" in right:
            kind, _, cnt = right.partition("*")
            kind = kind.strip()
            count = int(cnt.strip())
        else:
            kind = right
        arg = 0.0
        if kind.startswith("slow"):
            base, _, dur = kind.partition(":")
            if base != "slow":
                raise ValueError(f"unknown fault kind {kind!r}")
            arg = float(dur) if dur else _SLOW_DEFAULT_S
            if arg < 0.0:
                raise ValueError(f"slow duration must be >= 0: {kind!r}")
            kind = "slow"
        if kind not in _KINDS:
            raise ValueError(
                f"unknown fault kind {kind!r}; one of {sorted(_KINDS)}"
            )
        conds: dict[str, str] = {}
        site = left
        if "(" in left:
            if not left.endswith(")"):
                raise ValueError(f"unbalanced conditions in {raw!r}")
            site, _, inner = left.partition("(")
            for pair in inner[:-1].split(","):
                pair = pair.strip()
                if not pair:
                    continue
                if "=" not in pair:
                    raise ValueError(f"bad condition {pair!r} in {raw!r}")
                k, _, v = pair.partition("=")
                conds[k.strip()] = v.strip()
        if not site.strip():
            raise ValueError(f"fault rule missing site: {raw!r}")
        rules.append(_Rule(site.strip(), conds, kind, count, arg))
    return rules


def configure_faults(spec: str | None) -> None:
    """Install a fault script (None/empty disables injection)."""
    global _RULES, _ENABLED
    with _LOCK:
        _RULES = parse_spec(spec) if spec else []
        _ENABLED = bool(_RULES)


def refresh_from_env() -> bool:
    """Re-read ``TNC_TPU_FAULTS`` (import-time default)."""
    configure_faults(os.environ.get("TNC_TPU_FAULTS"))
    return _ENABLED


def enabled() -> bool:
    return _ENABLED


@contextlib.contextmanager
def faults(spec: str | None):
    """Scoped fault script for tests; restores the previous script."""
    global _RULES, _ENABLED
    with _LOCK:
        prev_rules, prev_enabled = _RULES, _ENABLED
    configure_faults(spec)
    try:
        yield
    finally:
        with _LOCK:
            _RULES, _ENABLED = prev_rules, prev_enabled


def fault_point(site: str, **ctx) -> None:
    """Declare an injectable boundary. Disabled path: one bool check.

    When a matching armed rule exists, decrements its count and raises
    the scripted error (or SIGKILLs the process for ``kill`` — the
    crash-resume smoke's deterministic "preemption mid-range").
    """
    if not _ENABLED:
        return
    _fire(site, ctx)


def _fire(site: str, ctx: dict) -> None:
    with _LOCK:
        rule = None
        for r in _RULES:
            if r.site != site or r.remaining == 0:
                continue
            if all(str(ctx.get(k)) == v for k, v in r.conds.items()):
                rule = r
                break
        if rule is None:
            return
        if rule.remaining > 0:
            rule.remaining -= 1
    obs.counter_add("resilience.faults.fired", site=site, kind=rule.kind)
    logger.warning(
        "faultinject: firing %s at %s (ctx=%s)", rule.kind, site, ctx
    )
    if rule.kind == "kill":
        os.kill(os.getpid(), signal.SIGKILL)
        return  # pragma: no cover — unreachable
    if rule.kind == "slow":
        import time

        time.sleep(rule.arg)
        return
    exc_type, msg = _KINDS[rule.kind]
    raise exc_type(msg.format(site=site))


refresh_from_env()
