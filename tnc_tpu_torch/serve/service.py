"""Query-serving front end: one mixed queue + micro-batching dispatcher
(the port's copy of ``tnc_tpu.serve.service``).

:class:`ContractionService` turns a :class:`~tnc_tpu_torch.serve.rebind.
BoundProgram` into a request server. Callers submit bitstrings from any
thread (or ``await`` the asyncio facade); a dispatcher thread collects
requests into micro-batches — up to ``max_batch`` riders or
``max_wait_ms`` after the first arrival, whichever comes first — and
issues ONE rebind dispatch per batch: one planned program, B bitstrings
on a leading batch axis (``TorchBackend.execute_batched``).

Beyond amplitudes, the queue is **mixed**: bitstring sampling, Pauli
expectation values and marginal sweeps are ``submit()``-able query
types (:meth:`~ContractionService.submit_sample` /
:meth:`~ContractionService.submit_expectation` /
:meth:`~ContractionService.submit_marginal`), each handled by a
registered :mod:`tnc_tpu_torch.queries.handlers` handler. Every request
carries a per-type **batching key** (the marginal key includes the
wildcard mask); the dispatcher partitions each micro-batch window by
key, so a dispatched batch never mixes structures while all types
share one queue, one deadline/admission policy, and one plan cache.
Per-type counters and latency percentiles ride ``stats()["by_type"]``.

Production posture:

- **admission control**: a bounded queue; submissions beyond
  ``max_queue`` fail fast with :class:`QueueFullError`;
- **deadlines**: each request may carry a timeout; requests that
  expire while queued are completed with
  :class:`DeadlineExceededError` at batch assembly (they never waste a
  dispatch);
- **resilience**: the batch dispatch runs under the shared
  :class:`~tnc_tpu_torch.resilience.retry.RetryPolicy` behind the
  ``serve.dispatch`` fault point (transient failures retry with backoff);
  a batch that still fails **degrades to singleton requests** — each
  rider is re-dispatched alone, so one poisoned request cannot fail its
  co-riders;
- **dedup**: identical riders of one window (amplitudes, and the
  deterministic query kinds) collapse to one dispatch entry;
- **plan swaps**: :meth:`~ContractionService.swap_bound` stages another
  :class:`BoundProgram` of the SAME structure, adopted between batches;
- **fidelity tiers**: ``submit``/``submit_expectation``/
  ``submit_marginal`` accept ``rtol=`` (default exact). A tolerant
  request routes through the :class:`FidelityRouter` to the
  **approximate tier** — a boundary-MPS chi-ladder
  (:mod:`tnc_tpu_torch.approx`) with its own batching key — and comes
  back as an :class:`ApproxAnswer` carrying ``(value, err, chi_used)``. A
  ladder that cannot meet the tolerance **escalates** to the exact
  pipeline; per-tier rows ride ``stats()["by_tier"]``.

On the card. ``backend=None`` builds ONE :class:`~tnc_tpu_torch.ops.
backends.TorchBackend` in the constructor (it raises without CUDA) and
keeps it for the service's life, so its kernel policies persist across
batches (the reference takes its numpy backend per call). The dispatcher
thread is the only thread of the service that touches CUDA; the backend
enters ``torch.inference_mode`` itself and names its device on every
tensor it makes, because both the mode and the current device are per
thread. CUDA graph captures run in thread-local mode
(:mod:`tnc_tpu_torch.ops.graphs`), so a caller's own CUDA work on another
thread does not invalidate the dispatcher's capture.

The in-process planes: the SLO engine (``slo=``, :meth:`attach_slo`;
:mod:`tnc_tpu_torch.obs.slo`), the cost-truth loop
(:meth:`enable_cost_truth`; :mod:`tnc_tpu_torch.obs.cost_truth`), the
telemetry endpoint (:meth:`serve_telemetry`; :mod:`tnc_tpu_torch.obs.http`),
the background replanner and the shared-cache watcher
(:mod:`tnc_tpu_torch.serve.replan`) and the planner pod
(:meth:`enable_plansvc`; :mod:`tnc_tpu_torch.serve.plansvc`). Their
threads do host work only; what reaches the card (a swapped plan, an
adopted cost model) is adopted by the dispatcher at a batch boundary. An
adopted cost-model generation reaches the service's ``cost_model``, the
:class:`FidelityRouter` and the replanner, not the backend's own fit
(:meth:`~tnc_tpu_torch.ops.backends.TorchBackend.cost_model`), so the
kernel policies and ``policy_key()`` go on naming the fit they were
planned from.

The fleet and elastic planes: :meth:`attach_fleet` joins the replica
registry (:mod:`tnc_tpu_torch.obs.fleet`: heartbeat, ``/fleet``
federation), a :class:`~tnc_tpu_torch.serve.multihost.ClusterDispatcher`
spreads each batch over the processes of a ``torch.distributed`` group,
and :meth:`enable_elastic` (:mod:`tnc_tpu_torch.serve.elastic`) adds
per-tenant quotas, weighted-fair window selection and priorities. A
``TorchBackend`` has no slice hooks, so on the card a higher priority
dispatches next but preempts nothing (on a ``NumpyBackend`` it preempts a
sliced contraction at a checkpoint boundary, as in the reference).
"""

from __future__ import annotations

import concurrent.futures
import itertools
import logging
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Iterable

import numpy as np

from tnc_tpu_torch import obs
from tnc_tpu_torch.obs import fleet as _fleet
from tnc_tpu_torch.obs.core import QuantileSummary
from tnc_tpu_torch.ops.backends import TorchBackend
from tnc_tpu_torch.resilience import retry as _retry
from tnc_tpu_torch.resilience.faultinject import fault_point
from tnc_tpu_torch.serve.rebind import (
    BoundProgram,
    bind_circuit,
    plan_signature,
    pow2_bucket,
)

logger = logging.getLogger(__name__)

#: drift-bucket granularity: the reference's power-of-two rule (its
#: rebind pads batched dispatches to it; the port pads none, and keeps
#: the buckets so that drift rows compare across the two packages)
batch_bucket = pow2_bucket

#: the approximate tier's request kind (its batching keys are
#: ``(APPROX_KIND, base kind)`` — approx traffic never co-batches with
#: exact traffic OR across base kinds)
APPROX_KIND = "approx"

def tier_of(kind: str) -> str:
    """The fidelity tier a request kind serves from.

    >>> tier_of("approx"), tier_of("amplitude")
    ('approx', 'exact')
    """
    return "approx" if kind == APPROX_KIND else "exact"


class ServeError(RuntimeError):
    """Base class for serving-layer failures."""


class QueueFullError(ServeError):
    """Admission control rejected the request (queue at ``max_queue``)."""


class TenantQuotaError(QueueFullError):
    """Admission control rejected the request: its tenant is at its
    per-tenant queued-request quota (elastic scheduling); subclasses
    :class:`QueueFullError` so existing backpressure handling applies."""


class DeadlineExceededError(ServeError):
    """The request's deadline passed before it could be dispatched."""


class ServiceClosedError(ServeError):
    """The service is stopped and no longer accepts requests."""


@dataclass
class _Request:
    bits: object  # the validated payload (determined bits for amplitudes)
    future: concurrent.futures.Future
    deadline: float | None  # absolute monotonic, None = no deadline
    t_submit: float = field(default_factory=time.monotonic)
    kind: str = "amplitude"
    # batching key: requests dispatch together ONLY when keys match
    # (per-type, plus structure discriminators like the marginal mask)
    key: tuple = ("amplitude",)
    # per-request trace id, assigned at admission; every serve.* span
    # that touches this request carries it
    rid: int = 0
    t_collect: float = 0.0  # when batch assembly pulled it off the queue
    # elastic scheduling: weighted-fair tenant + priority class (higher
    # wins; a strictly-higher priority may preempt a running sliced
    # contraction at a checkpoint boundary, on a backend with slice hooks)
    tenant: str = "default"
    priority: int = 0


_STATS_CAP = 4096  # bounded in-memory samples for stats()


class ContractionService:
    """Micro-batching amplitude server over one bound program.

    >>> from tnc_tpu_torch.builders.circuit_builder import Circuit
    >>> from tnc_tpu_torch.ops.backends import NumpyBackend
    >>> from tnc_tpu_torch.tensornetwork.tensordata import TensorData
    >>> c = Circuit(); reg = c.allocate_register(2)
    >>> c.append_gate(TensorData.gate("h"), [reg.qubit(0)])
    >>> c.append_gate(TensorData.gate("cx"), [reg.qubit(0), reg.qubit(1)])
    >>> with ContractionService.from_circuit(c, backend=NumpyBackend()) as svc:
    ...     amp = svc.amplitude("00")
    >>> round(abs(amp), 6)
    0.707107
    """

    def __init__(
        self,
        bound: BoundProgram,
        backend=None,
        max_batch: int = 32,
        max_wait_ms: float = 2.0,
        max_queue: int = 1024,
        retry_policy: _retry.RetryPolicy | None = None,
        dispatcher=None,
        slo=None,
        cost_model=None,
    ):
        """``backend``: the backend every batch runs on, kept for the
        service's life; ``None`` builds one ``TorchBackend()`` here (on
        the card; it raises without CUDA).

        ``dispatcher``: optional batch-execution hook ``fn(bound, bits,
        backend) -> (B,)+result_shape array`` replacing the local
        ``bound.amplitudes_det`` dispatch — the multi-process fan-out
        point (:class:`~tnc_tpu_torch.serve.multihost.ClusterDispatcher`
        shards the micro-batch across processes and gathers at the root).
        Everything else (queueing, deadlines, retry, degradation, plan
        swaps) is unchanged: the dispatcher is only ever called with a
        batch and the CURRENT bound, so plan swaps stay batch-atomic across
        the fleet.

        ``slo``: an :class:`~tnc_tpu_torch.obs.slo.SLOEngine` (or an
        :class:`~tnc_tpu_torch.obs.slo.SLOConfig` to build one) — every
        terminal request outcome and every dispatch measurement feeds
        it, burn and drift alerts surface in ``stats()["slo"]`` and the
        telemetry endpoint. ``cost_model``: a :class:`~tnc_tpu_torch.obs.
        calibrate.CalibratedCostModel` giving the drift detector its
        predicted dispatch seconds and the :class:`FidelityRouter` its
        rung prices (without one, drift tracks raw measured seconds per
        bucket)."""
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.bound = bound
        self.backend = backend if backend is not None else TorchBackend()
        self.dispatcher = dispatcher
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.max_queue = int(max_queue)
        self.retry_policy = retry_policy or _retry.default_policy()
        self.cost_model = cost_model
        self._queue: deque[_Request] = deque()
        self._cond = threading.Condition()
        self._running = False
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()
        self._counts = {
            "submitted": 0, "completed": 0, "failed": 0,
            "expired": 0, "rejected": 0, "cancelled": 0,
            "batches": 0, "degraded_batches": 0, "plan_swaps": 0,
            "deduped": 0,
        }
        # observability-only references, set by from_circuit (or by the
        # owner directly): surfaced in stats()
        self._plan_cache = None
        self.reuse_store = None
        self._batch_sizes: deque[int] = deque(maxlen=_STATS_CAP)
        # bounded streaming percentiles (p50/p90/p99 without retained
        # samples), cumulative since start / reset_stats()
        self._latencies = QuantileSummary()
        # per-query-type breakdowns (kind -> counts / latency summary);
        # "amplitude" is pre-seeded so the primary type is always listed
        self._by_type: dict[str, dict] = {}
        self._latencies_by_type: dict[str, QuantileSummary] = {}
        self._ensure_type("amplitude")
        # per-fidelity-tier breakdowns ("exact" pre-seeded; "approx"
        # appears when a FidelityRouter is attached): counts, latency
        # summaries, and measured dispatch seconds
        self._by_tier: dict[str, dict] = {}
        self._latencies_by_tier: dict[str, QuantileSummary] = {}
        self._tier_dispatch: dict[str, list] = {}
        self._ensure_tier("exact")
        # registered query handlers (sampling / expectation / marginal)
        self._handlers: dict[str, object] = {}
        self._router = None  # attached FidelityRouter, if any
        # a BoundProgram staged by swap_bound; the dispatcher adopts it
        # at the next batch boundary
        self._pending_bound: BoundProgram | None = None
        self._rids = itertools.count(1)
        # plan-swap generation: bumps on every adopted swap; rides the
        # dispatch spans and request timelines
        self._generation = 0
        self._replanner = None  # attached BackgroundReplanner, if any
        self._plansvc = None  # attached PlannerFleet pod, if any
        self._watchers: list = []  # SharedCacheWatchers, ModelRegistryWatchers
        self._telemetry = None  # attached TelemetryServer, if any
        # fleet plane (attach_fleet): replica-registry membership +
        # heartbeat + the /fleet federation source
        self._fleet_registry = None
        self._fleet_heartbeat = None
        self._fleet_aggregator = None
        self._slo = None
        self._slo_last_check = 0.0
        # cost-truth plane (enable_cost_truth): production sampling,
        # refits, versioned model adoption, the plan scoreboard and the
        # post-swap rollback watch
        self._cost_truth = None
        # per-bound derived constants (program flops/bytes/steps, plan
        # key and signature), memoized by bound identity
        self._bound_profiles: dict[int, dict] = {}
        # elastic plane (enable_elastic): tenant/priority scheduling
        # config, advisory scale controller, preemption state (the
        # priority of the batch currently dispatching, and a recursion
        # guard so interlude work is itself never preempted)
        self._elastic = None
        self._elastic_controller = None
        self._active_priority = 0
        self._in_interlude = False
        self.attach_slo(slo)

    @classmethod
    def from_circuit(
        cls,
        circuit,
        mask=None,
        pathfinder=None,
        plan_cache=None,
        backend=None,
        target_size=None,
        reuse_store=None,
        background_replan: bool = False,
        replan_options: dict | None = None,
        shared_cache_watch: bool = False,
        watch_options: dict | None = None,
        queries: bool = False,
        approx: bool = False,
        approx_options: dict | None = None,
        telemetry_port: int | None = None,
        fleet_dir: str | None = None,
        fleet_endpoints=None,
        fleet_heartbeat_s: float = 2.0,
        cost_truth: bool = False,
        cost_truth_options: dict | None = None,
        plansvc: bool = False,
        plansvc_dir: str | None = None,
        plansvc_options: dict | None = None,
        **kwargs,
    ) -> "ContractionService":
        """Build (plan/compile once, plan cache honored) and start.

        ``queries=True`` additionally registers the sampling /
        expectation / marginal query handlers for the same circuit
        (:func:`tnc_tpu_torch.queries.handlers.attach_query_handlers`),
        sharing ``plan_cache``/``target_size``; the circuit is copied
        before the amplitude finalizer consumes it.

        ``approx=True`` additionally attaches a :class:`FidelityRouter`
        for the same circuit (nearest-neighbour circuits only):
        ``submit*`` calls gain a working ``rtol=`` and tolerant requests
        serve from the boundary-MPS chi-ladder tier, escalating to the
        exact pipeline on a tolerance miss. ``approx_options`` are
        :meth:`enable_approx` kwargs.

        ``background_replan=True`` (requires ``plan_cache``) attaches a
        :class:`~tnc_tpu_torch.serve.replan.BackgroundReplanner`: a cache
        miss is answered from the fast greedy plan at once, and the
        worker hyper-optimizes the structure between requests, swapping
        in the improved plan when its predicted cost wins.
        ``replan_options`` are its constructor kwargs.

        ``shared_cache_watch=True`` (requires ``plan_cache``) attaches a
        :class:`~tnc_tpu_torch.serve.replan.SharedCacheWatcher`: replicas
        sharing one cache directory adopt each other's published plans
        at batch boundaries. ``watch_options`` are its kwargs.

        ``plansvc=True`` (requires ``plan_cache``) attaches a
        :class:`~tnc_tpu_torch.serve.plansvc.PlannerFleet` pod
        (:meth:`enable_plansvc`) on the trial board ``plansvc_dir``
        (default: ``plansvc/`` inside the plan-cache directory);
        ``plansvc_options`` are its kwargs.

        ``cost_truth=True`` turns on the cost-truth loop
        (:meth:`enable_cost_truth`); ``cost_truth_options`` are its kwargs
        (``registry=`` a shared model-registry directory).

        ``telemetry_port`` (0 = ephemeral) starts the scrape endpoint
        (:meth:`serve_telemetry`): ``/metrics``, ``/healthz``, ``/slo``,
        ``/calibration`` and ``/fleet``.

        ``fleet_dir`` / ``fleet_endpoints`` join the fleet observability
        plane (:meth:`attach_fleet`): this replica heartbeats into the
        shared registry directory every ``fleet_heartbeat_s`` seconds and
        the ``/fleet`` endpoint federates every replica's telemetry."""
        if background_replan and plan_cache is None:
            raise ValueError("background_replan requires a plan_cache")
        if shared_cache_watch and plan_cache is None:
            raise ValueError("shared_cache_watch requires a plan_cache")
        if plansvc and plan_cache is None:
            raise ValueError("plansvc requires a plan_cache")
        query_circuit = circuit.copy() if queries else None
        approx_circuit = circuit.copy() if approx else None
        bound = bind_circuit(
            circuit, mask, pathfinder, plan_cache, target_size, reuse_store
        )
        svc = cls(bound, backend=backend, **kwargs)
        svc._plan_cache = plan_cache
        svc.reuse_store = reuse_store
        svc.start()
        try:
            if queries:
                svc.enable_queries(
                    query_circuit,
                    pathfinder=pathfinder,
                    plan_cache=plan_cache,
                    target_size=target_size,
                )
            if approx:
                svc.enable_approx(approx_circuit, **(approx_options or {}))
            if background_replan:
                from tnc_tpu_torch.serve.replan import BackgroundReplanner

                BackgroundReplanner(
                    svc, plan_cache, **(replan_options or {})
                ).start()
            if shared_cache_watch:
                from tnc_tpu_torch.serve.replan import SharedCacheWatcher

                watcher = SharedCacheWatcher(
                    svc, plan_cache, **(watch_options or {})
                )
                svc._watchers.append(watcher)
                watcher.start()
            if plansvc:
                svc.enable_plansvc(
                    directory=plansvc_dir, **(plansvc_options or {})
                )
            if cost_truth or cost_truth_options:
                svc.enable_cost_truth(**(cost_truth_options or {}))
            if telemetry_port is not None:
                svc.serve_telemetry(port=telemetry_port)
            if fleet_dir is not None or fleet_endpoints:
                svc.attach_fleet(
                    directory=fleet_dir,
                    endpoints=fleet_endpoints or (),
                    heartbeat_s=fleet_heartbeat_s,
                )
        except Exception:
            # a bad option kwarg must not leak a running dispatcher thread
            # (or half the attachments) the caller cannot reach
            svc.stop()
            raise
        return svc

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "ContractionService":
        with self._cond:
            if self._running:
                return self
            self._running = True
        self._thread = threading.Thread(
            target=self._dispatch_loop, name="tnc-serve-dispatch", daemon=True
        )
        self._thread.start()
        return self

    def stop(self, drain: bool = True) -> None:
        """Stop accepting requests; by default finish ('drain') what is
        already queued, otherwise fail queued requests with
        :class:`ServiceClosedError`. The planner pod stops first (the
        replanner's delegate path blocks on it), then the replanner, the
        watchers, the fleet heartbeat (a clean leave) and the telemetry
        endpoint (which releases its port)."""
        pod, self._plansvc = self._plansvc, None
        if pod is not None:
            pod.stop()
        replanner, self._replanner = self._replanner, None
        if replanner is not None:
            replanner.stop()
        watchers, self._watchers = list(self._watchers), []
        for watcher in watchers:
            watcher.stop()
        heartbeat, self._fleet_heartbeat = self._fleet_heartbeat, None
        if heartbeat is not None:
            heartbeat.stop()  # retires the registry entry: clean leave
        telemetry, self._telemetry = self._telemetry, None
        if telemetry is not None:
            telemetry.stop()
        with self._cond:
            if not self._running:
                return
            self._running = False
            if not drain:
                while self._queue:
                    req = self._queue.popleft()
                    self._complete(req, exc=ServiceClosedError("stopped"))
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=60.0)
            self._thread = None

    def __enter__(self) -> "ContractionService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- plan swap ---------------------------------------------------------

    def swap_bound(self, bound: BoundProgram) -> None:
        """Stage another :class:`BoundProgram` for the SAME circuit
        structure. The dispatcher adopts it at the next batch boundary —
        batches are dispatched wholly under one bound, so no in-flight
        request ever mixes plans. Amplitude *values* are plan-independent
        (both programs contract the same network)."""
        from tnc_tpu_torch.serve.plancache import network_structure_digest

        if bound.template is not self.bound.template:
            # same structure digest (legs/dims/budget) AND same leaf
            # values: the digest is value-blind by design (all bitstrings
            # share it), but a swap with different gate VALUES would
            # silently serve another circuit's amplitudes
            if network_structure_digest(
                bound.template.network, bound.target_size
            ) != network_structure_digest(
                self.bound.template.network, self.bound.target_size
            ) or not all(
                np.array_equal(a, b)
                for a, b in zip(bound.arrays, self.bound.arrays)
            ):
                raise ValueError(
                    "swap_bound: replacement program was bound for a "
                    "different structure or different leaf values — "
                    "not a plan for this service's circuit/budget"
                )
        with self._lock:
            self._pending_bound = bound

    def _current_bound(self) -> BoundProgram:
        """The bound to dispatch the NEXT batch under, adopting any staged
        replacement (and any staged cost-model generation) first — the
        one boundary where swaps become visible, so no batch ever mixes
        plans or model versions."""
        ct = self._cost_truth
        refused = prior = None
        with self._lock:
            pending, self._pending_bound = self._pending_bound, None
            if pending is not None:
                if ct is not None and ct.is_pinned(plan_signature(pending)):
                    # a rolled-back plan staged again (watcher, replanner
                    # re-run): refuse it, keep serving
                    refused, pending = pending, None
                else:
                    prior = self.bound
                    self.bound = pending
                    self._counts["plan_swaps"] += 1
                    self._generation += 1
        if refused is not None:
            ct.count("pin_refusals")
            obs.counter_add("serve.cost_truth.pin_refused")
            logger.warning("refused adoption of a regression-pinned plan")
        if pending is not None:
            obs.counter_add("serve.replan.adopted")
            logger.info("adopted a swapped program for serving")
            if ct is not None:
                self._arm_swap_watch(pending, prior)
        if ct is not None:
            adopted = ct.adopt_pending()
            if adopted is not None:
                self._adopt_cost_model(*adopted)
        return self.bound

    def queue_depth(self) -> int:
        """Instantaneous queue length."""
        with self._cond:
            return len(self._queue)

    def attach_slo(self, slo) -> "ContractionService":
        """Attach (or replace, or None-detach) the SLO engine — an
        :class:`~tnc_tpu_torch.obs.slo.SLOEngine` or an
        :class:`~tnc_tpu_torch.obs.slo.SLOConfig` to build one. Attach
        after a warm-up, so that first-call requests never count against
        the objectives or seed the drift baselines."""
        if slo is not None and not hasattr(slo, "record_request"):
            from tnc_tpu_torch.obs.slo import SLOEngine

            slo = SLOEngine(slo)
        self._slo = slo
        return self

    def enable_plansvc(
        self, directory: str | None = None, **options
    ) -> "ContractionService":
        """Attach a :class:`~tnc_tpu_torch.serve.plansvc.PlannerFleet` pod:
        a daemon that — only while the request queue is empty — runs
        planner trials against the shared trial board under
        ``directory`` (default: ``plansvc/`` inside the plan-cache
        directory) and merges the best plan through the plan cache and
        ``swap_bound``. Requires a plan cache. ``options`` are
        :class:`~tnc_tpu_torch.serve.plansvc.PlannerFleet` kwargs
        (``ntrials``, ``margin``, ``sa_steps``, ``cost_model``...). A
        re-attach replaces the previous pod."""
        from tnc_tpu_torch.serve.plansvc import PlannerFleet

        if self._plan_cache is None:
            raise ValueError("enable_plansvc requires a plan_cache")
        if self._plansvc is not None:
            self._plansvc.stop()
            self._plansvc = None
        PlannerFleet(
            self, self._plan_cache, directory=directory, **options
        ).start()
        return self

    # -- elastic scheduling (tenants / priority / scaling) -----------------

    def enable_elastic(
        self, config=None, controller=None
    ) -> "ContractionService":
        """Turn on elastic scheduling: ``submit(tenant=, priority=)`` gains
        weighted-fair window selection and per-tenant quotas (``config``,
        an :class:`~tnc_tpu_torch.serve.elastic.ElasticConfig`; default
        config = fair weights, no quotas), and local sliced dispatches
        become priority-preemptible at checkpoint boundaries on a backend
        with slice hooks (a ``TorchBackend`` has none: there a higher
        priority dispatches next and preempts nothing). ``controller`` (an
        :class:`~tnc_tpu_torch.serve.elastic.ElasticController`)
        additionally arms :meth:`elastic_check` — the advisory
        scale-decision step."""
        from tnc_tpu_torch.serve import elastic as _elastic_mod

        self._elastic = (
            config if config is not None else _elastic_mod.ElasticConfig()
        )
        self._elastic_controller = controller
        return self

    def elastic_check(self) -> dict | None:
        """One advisory controller step: fold the current queue depth, the
        fleet roster's live count and the worst SLO burn rate into a scale
        decision (None without a controller). The decision also lands in
        ``stats()["elastic"]["controller"]`` and fans out to the
        controller's ``on_decision`` hooks — actuate it with a
        :class:`~tnc_tpu_torch.serve.elastic.LocalAutoscaler` or external
        infrastructure."""
        ctrl = self._elastic_controller
        if ctrl is None:
            return None
        live = 1
        if self._fleet_registry is not None:
            try:
                live = max(int(self._fleet_registry.roster()["live"]), 1)
            except Exception:  # noqa: BLE001 — roster is advisory input
                pass
        burn = 0.0
        if self._slo is not None:
            burn = type(ctrl).burn_from_slo(self._slo.stats())
        return ctrl.decide(self.queue_depth(), live, burn)

    def _tenant_depths(self) -> dict[str, int]:
        """Queued requests per tenant (stats / heartbeat surface)."""
        with self._cond:
            depths: dict[str, int] = {}
            for req in self._queue:
                depths[req.tenant] = depths.get(req.tenant, 0) + 1
            return depths

    # -- query handlers ----------------------------------------------------

    def register_query_handler(self, handler) -> None:
        """Register a query-type handler (``kind`` attribute +
        ``validate(payload) -> (payload, key)`` at admission +
        ``dispatch(payloads, backend) -> results`` per batch — the
        :mod:`tnc_tpu_torch.queries.handlers` protocol). One handler per
        kind; re-registering replaces."""
        self._handlers[str(handler.kind)] = handler

    def enable_queries(
        self,
        circuit,
        pathfinder=None,
        plan_cache=None,
        target_size=None,
    ) -> "ContractionService":
        """Register the sampling / expectation / marginal handlers for
        ``circuit`` (copied, not consumed)."""
        from tnc_tpu_torch.queries.handlers import attach_query_handlers

        attach_query_handlers(
            self, circuit,
            pathfinder=pathfinder, plan_cache=plan_cache,
            target_size=target_size,
        )
        return self

    def enable_approx(self, circuit, **options) -> "ContractionService":
        """Attach a :class:`FidelityRouter` for ``circuit`` (copied, not
        consumed; nearest-neighbour circuits only — the attach fails fast
        otherwise). ``options`` are router kwargs (``chis``, ``chi_cap``,
        ``safety``, ``max_escalations``, ``cost_model``). Afterwards
        ``submit*(..., rtol=...)`` routes to the approximate tier."""
        router = FidelityRouter(self, circuit, **options)
        self.register_query_handler(router)
        self._router = router
        self._ensure_tier("approx")
        return self

    @property
    def fidelity_router(self):
        """The attached :class:`FidelityRouter` (None = exact only)."""
        return self._router

    # -- submission --------------------------------------------------------

    def _enqueue(
        self,
        kind: str,
        key: tuple,
        payload,
        timeout_s: float | None,
        tenant: str = "default",
        priority: int = 0,
    ) -> concurrent.futures.Future:
        """Shared admission path for every query type: bounded queue,
        per-tenant quota (elastic), deadline arming, request-id
        assignment, global + per-type accounting."""
        fut: concurrent.futures.Future = concurrent.futures.Future()
        deadline = (
            time.monotonic() + float(timeout_s) if timeout_s is not None else None
        )
        tenant = str(tenant)
        with self._cond:
            if not self._running:
                self._count("rejected")
                self._count_type(kind, "rejected")
                obs.counter_add("serve.requests.rejected", reason="closed")
                self._slo_request(kind, 0.0, "rejected")
                raise ServiceClosedError("service is not running")
            if len(self._queue) >= self.max_queue:
                self._count("rejected")
                self._count_type(kind, "rejected")
                obs.counter_add("serve.requests.rejected", reason="queue_full")
                self._slo_request(kind, 0.0, "rejected")
                raise QueueFullError(
                    f"queue at max_queue={self.max_queue}; retry later"
                )
            cfg = self._elastic
            if cfg is not None and cfg.tenant_quotas:
                quota = cfg.tenant_quotas.get(tenant)
                if quota is not None and sum(
                    1 for r in self._queue if r.tenant == tenant
                ) >= int(quota):
                    self._count("rejected")
                    self._count_type(kind, "rejected")
                    obs.counter_add(
                        "serve.requests.rejected", reason="tenant_quota"
                    )
                    self._slo_request(kind, 0.0, "rejected")
                    raise TenantQuotaError(
                        f"tenant {tenant!r} at quota {quota}; retry later"
                    )
            self._queue.append(
                _Request(payload, fut, deadline, kind=kind, key=key,
                         rid=next(self._rids),
                         tenant=tenant, priority=int(priority))
            )
            depth = len(self._queue)
            self._cond.notify()
        self._count("submitted")
        self._count_type(kind, "submitted")
        obs.counter_add("serve.requests.submitted")
        obs.counter_add("serve.query.submitted", type=kind)
        obs.gauge_set("serve.queue_depth", depth)
        return fut

    def submit(
        self,
        bitstring: str | Iterable,
        timeout_s: float | None = None,
        rtol: float | None = None,
        tenant: str = "default",
        priority: int = 0,
    ) -> concurrent.futures.Future:
        """Enqueue one amplitude request; returns a ``Future`` resolving
        to the amplitude (complex scalar, or an ndarray over the
        template's open legs). ``timeout_s`` arms a deadline.

        ``rtol`` (default None = exact) routes the request to the
        approximate tier: the future resolves to an
        :class:`ApproxAnswer` whose error estimate meets
        ``rtol · max(|value|, 2^(-n/2))`` — or, when the chi-ladder
        cannot meet it, to the escalated exact answer.

        ``tenant`` / ``priority`` engage the elastic scheduler
        (:meth:`enable_elastic`): tenants share the window weighted-fair
        under per-tenant quotas, and a strictly-higher ``priority`` jumps
        the queue — preempting a running sliced contraction at its next
        checkpoint boundary on a backend with slice hooks."""
        if rtol is not None:
            return self._submit_approx("amplitude", bitstring, rtol, timeout_s)
        # validate at admission: a malformed request must fail alone,
        # immediately — not poison a whole batch at dispatch time. The
        # determined-position bits are what gets queued, and dispatch
        # never re-validates
        bitstring = self.bound.template.request_bits(bitstring)
        return self._enqueue(
            "amplitude", ("amplitude",), bitstring, timeout_s,
            tenant=tenant, priority=priority,
        )

    def _submit_approx(
        self, base: str, payload, rtol, timeout_s: float | None
    ) -> concurrent.futures.Future:
        """Route a tolerant request to the approximate tier (its own
        batching key per base kind)."""
        router = self._handlers.get(APPROX_KIND)
        if router is None:
            raise ValueError(
                "rtol= routes to the approximate tier; attach it first "
                "(from_circuit(approx=True) / enable_approx)"
            )
        payload, key = router.validate(
            {"kind": base, "payload": payload, "rtol": rtol}
        )
        return self._enqueue(APPROX_KIND, tuple(key), payload, timeout_s)

    def submit_query(
        self, kind: str, payload, timeout_s: float | None = None,
        tenant: str = "default", priority: int = 0,
    ) -> concurrent.futures.Future:
        """Enqueue one typed query request through its registered
        handler; the handler validates the payload at admission and
        assigns the batching key."""
        handler = self._handlers.get(kind)
        if handler is None:
            raise ValueError(
                f"no handler registered for query kind {kind!r} "
                "(enable_queries / register_query_handler first)"
            )
        payload, key = handler.validate(payload)
        return self._enqueue(
            kind, tuple(key), payload, timeout_s,
            tenant=tenant, priority=priority,
        )

    def submit_sample(
        self, n_samples: int = 1, seed=None, timeout_s: float | None = None
    ) -> concurrent.futures.Future:
        """Sample ``n_samples`` bitstrings from |⟨b|C|0⟩|² (chain-rule
        sampler); the future resolves to a list of bitstrings. A seeded
        request's stream is deterministic regardless of co-riders."""
        return self.submit_query(
            "sample", {"n_samples": n_samples, "seed": seed}, timeout_s
        )

    def submit_expectation(
        self, terms, timeout_s: float | None = None, rtol: float | None = None
    ) -> concurrent.futures.Future:
        """⟨ψ|P|ψ⟩ (a Pauli string) or a Pauli sum (iterable of
        ``(coeff, pauli)``); the future resolves to the complex value.
        ``rtol`` routes to the approximate tier (an :class:`ApproxAnswer`)."""
        if rtol is not None:
            return self._submit_approx("expectation", terms, rtol, timeout_s)
        return self.submit_query("expectation", terms, timeout_s)

    def submit_marginal(
        self, pattern, timeout_s: float | None = None, rtol: float | None = None
    ) -> concurrent.futures.Future:
        """Marginal probability of ``pattern``'s determined bits
        (``'*'`` = marginalized); the future resolves to a float.
        ``rtol`` routes to the approximate tier (an :class:`ApproxAnswer`)."""
        if rtol is not None:
            return self._submit_approx("marginal", pattern, rtol, timeout_s)
        return self.submit_query("marginal", pattern, timeout_s)

    @staticmethod
    def _wait(timeout_s: float | None) -> float | None:
        return None if timeout_s is None else float(timeout_s) + 60.0

    def sample(self, n_samples: int = 1, seed=None,
               timeout_s: float | None = None) -> list:
        """Blocking :meth:`submit_sample`."""
        return self.submit_sample(n_samples, seed, timeout_s).result(
            timeout=self._wait(timeout_s))

    def expectation(self, terms, timeout_s: float | None = None,
                    rtol: float | None = None) -> complex:
        """Blocking :meth:`submit_expectation`."""
        return self.submit_expectation(terms, timeout_s, rtol=rtol).result(
            timeout=self._wait(timeout_s))

    def marginal(self, pattern, timeout_s: float | None = None,
                 rtol: float | None = None) -> float:
        """Blocking :meth:`submit_marginal`."""
        return self.submit_marginal(pattern, timeout_s, rtol=rtol).result(
            timeout=self._wait(timeout_s))

    def amplitude(self, bitstring, timeout_s: float | None = None,
                  rtol: float | None = None):
        """Blocking single-amplitude query (deadline doubles as the
        caller-side wait bound)."""
        return self.submit(bitstring, timeout_s, rtol=rtol).result(
            timeout=self._wait(timeout_s))

    async def amplitude_async(self, bitstring, timeout_s: float | None = None):
        """Asyncio facade: ``await service.amplitude_async("0101")``."""
        import asyncio

        return await asyncio.wrap_future(self.submit(bitstring, timeout_s))

    # -- dispatcher --------------------------------------------------------

    def _collect_batch(self) -> list[_Request] | None:
        """Block for the first request, then hold the window open up to
        ``max_wait_s`` (or until ``max_batch`` riders); None = stopped
        and drained."""
        with self._cond:
            while not self._queue:
                if not self._running:
                    return None
                self._cond.wait(timeout=0.1)
            deadline = time.monotonic() + self.max_wait_s
            while (
                len(self._queue) < self.max_batch
                and time.monotonic() < deadline
            ):
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._cond.wait(timeout=remaining):
                    break
            cfg = self._elastic
            if cfg is not None and len(self._queue) > 1:
                # elastic window selection: priority classes first,
                # weighted-fair across tenants within a class, FIFO
                # within a tenant (stride scheduling — see elastic.py)
                from tnc_tpu_torch.serve import elastic as _elastic_mod

                items = list(self._queue)
                order = _elastic_mod.weighted_fair_order(
                    items,
                    lambda r: r.tenant,
                    lambda r: r.priority,
                    weights=cfg.tenant_weights,
                )
                picked = order[: self.max_batch]
                taken = set(picked)
                batch = [items[i] for i in picked]
                self._queue = deque(
                    items[i] for i in range(len(items)) if i not in taken
                )
            else:
                batch = [
                    self._queue.popleft()
                    for _ in range(min(self.max_batch, len(self._queue)))
                ]
            obs.gauge_set("serve.queue_depth", len(self._queue))
            return batch

    def _dispatch_loop(self) -> None:
        while True:
            batch = self._collect_batch()
            if batch is None:
                return
            try:
                self._run_batch(batch)
            except Exception as exc:  # noqa: BLE001 — the dispatcher must survive
                # _run_batch handles dispatch failures itself; anything
                # reaching here is a bookkeeping bug — fail the batch,
                # keep serving
                logger.exception("dispatcher batch processing failed")
                for req in batch:
                    if not self._complete(
                        req, exc=ServeError(f"dispatcher error: {exc}")
                    ):
                        continue  # cancelled: _complete counted it
                    self._count("failed")
                    self._count_type(req.kind, "failed")
                    obs.counter_add("serve.requests.failed")
                    obs.counter_add("serve.query.failed", type=req.kind)
                    self._slo_request(
                        req.kind, time.monotonic() - req.t_submit, "failed"
                    )
                    self._trace_request(req, "failed")

    def _complete(self, req: _Request, result=None, exc=None) -> bool:
        """Resolve a request's future, tolerating caller-side
        cancellation (completing a cancelled future raises
        ``InvalidStateError``, which must never kill the dispatcher)."""
        try:
            if exc is not None:
                req.future.set_exception(exc)
            else:
                req.future.set_result(result)
            return True
        except concurrent.futures.InvalidStateError:
            self._count("cancelled")
            self._count_type(req.kind, "cancelled")
            obs.counter_add("serve.requests.cancelled")
            obs.counter_add("serve.query.cancelled", type=req.kind)
            self._slo_request(
                req.kind, time.monotonic() - req.t_submit, "cancelled"
            )
            self._trace_request(req, "cancelled")
            return False

    def _dispatch_amps(self, bound: BoundProgram, bits: list) -> np.ndarray:
        """One batch execution under ``bound`` — locally, or through the
        pluggable ``dispatcher`` (multi-process fan-out). With elastic
        scheduling enabled, local sliced dispatches run preemptibly on a
        backend with slice hooks: a strictly-higher-priority arrival
        forces a checkpoint save at the next slice boundary, the priority
        work runs in the interlude, and the contraction resumes
        bit-identically."""
        if self.dispatcher is not None:
            return self.dispatcher(bound, bits, self.backend)
        cfg = self._elastic
        if cfg is not None and cfg.preempt_enabled and not self._in_interlude:
            from tnc_tpu_torch.serve import elastic as _elastic_mod

            return _elastic_mod.preemptible_amplitudes(
                bound, bits, self.backend,
                ckpt=cfg.ckpt_dir,
                should_yield=self._should_preempt,
                interlude=self._priority_interlude,
                max_yields=cfg.max_yields,
            )
        return bound.amplitudes_det(bits, self.backend)

    def _should_preempt(self, cursor: int) -> bool:
        """The ``on_slice`` gate: yield when any queued request outranks
        the batch currently dispatching (never from inside an interlude —
        priority work itself runs to completion)."""
        if self._in_interlude:
            return False
        prio = self._active_priority
        with self._cond:
            return any(req.priority > prio for req in self._queue)

    def _priority_interlude(self) -> None:
        """Runs between a preempted contraction's yield and its resume:
        pull every request outranking the preempted batch off the queue and
        serve them as a nested batch (same plumbing — grouping, retry,
        degrade, accounting — under a recursion guard so the interlude is
        itself never preempted)."""
        prio = self._active_priority
        with self._cond:
            higher = [req for req in self._queue if req.priority > prio]
            for req in higher:
                self._queue.remove(req)
            if higher:
                obs.gauge_set("serve.queue_depth", len(self._queue))
        if not higher:
            return
        self._in_interlude = True
        try:
            self._run_batch(higher)
        finally:
            self._in_interlude = False
            self._active_priority = prio

    def _per_request(self, amps: np.ndarray, i: int):
        out = amps[i]
        # copy, not view: co-riders must never alias one mutable batch
        # buffer
        return complex(out) if out.shape == () else np.array(out)

    def _dispatch_group(
        self, kind: str, payloads: list, bound: BoundProgram
    ) -> list:
        """One batched execution of a same-key group; returns one result
        object per payload. The ``serve.dispatch`` fault point precedes
        it, where production dispatch failures surface."""
        fault_point("serve.dispatch", kind=kind, batch=len(payloads))
        if kind == "amplitude":
            amps = self._dispatch_amps(bound, payloads)
            return [self._per_request(amps, i) for i in range(len(payloads))]
        return self._handlers[kind].dispatch(payloads, self.backend)

    def _run_batch(self, batch: list[_Request]) -> None:
        now = time.monotonic()
        live: list[_Request] = []
        for req in batch:
            req.t_collect = now
            if req.deadline is not None and now > req.deadline:
                # complete FIRST: a caller-cancelled future takes the
                # cancelled outcome inside _complete, and exactly one
                # terminal outcome may count per request
                if self._complete(
                    req,
                    exc=DeadlineExceededError(
                        f"deadline exceeded after "
                        f"{now - req.t_submit:.3f}s in queue"
                    ),
                ):
                    self._count("expired")
                    self._count_type(req.kind, "expired")
                    obs.counter_add("serve.requests.expired")
                    self._slo_request(req.kind, now - req.t_submit, "expired")
                    self._trace_request(req, "expired")
            else:
                live.append(req)
        if not live:
            self._slo_check()
            return
        for req in live:
            obs.observe("serve.wait_s", now - req.t_submit)
        # one bound per window: adopt a staged swap at this boundary,
        # then every group of the window (including singleton-degrade
        # re-dispatches) runs under the SAME program
        bound = self._current_bound()
        # partition the window by batching key (insertion order): one
        # dispatch per key — a batch never mixes query types or structures
        groups: dict[tuple, list[_Request]] = {}
        for req in live:
            groups.setdefault(req.key, []).append(req)
        for group in groups.values():
            self._run_group(group, bound)
        self._slo_check()

    def _run_group(self, group: list[_Request], bound: BoundProgram) -> None:
        kind = group[0].kind
        # the running batch's priority class — what the preemption gate
        # compares queued arrivals against (single dispatcher thread;
        # interludes save/restore around their nested batch)
        self._active_priority = max(req.priority for req in group)
        self._count("batches")
        self._count_type(kind, "batches")
        with self._lock:
            self._batch_sizes.append(len(group))
            generation = self._generation
        obs.observe("serve.batch_size", len(group))
        obs.observe("serve.query.batch_size", len(group), type=kind)
        payloads = [req.bits for req in group]
        # queue-level dedup: identical riders inside one batch window
        # collapse to a single dispatch entry, the result fanned out
        # (copied) to every future. Deterministic kinds only —
        # amplitudes always, query handlers that opt in via
        # `dedup_payloads` (sampling is stochastic and never collapses)
        fan = None
        handler = self._handlers.get(kind)
        if len(group) > 1 and (
            kind == "amplitude" or getattr(handler, "dedup_payloads", False)
        ):
            try:
                index_of: dict = {}
                fan = [index_of.setdefault(p, len(index_of)) for p in payloads]
            except TypeError:  # unhashable payload shape: no dedup
                fan = None
            else:
                if len(index_of) == len(payloads):
                    fan = None
                else:
                    unique: list = [None] * len(index_of)
                    for p, j in index_of.items():
                        unique[j] = p
                    collapsed = len(payloads) - len(unique)
                    payloads = unique
                    with self._lock:
                        self._counts["deduped"] += collapsed
                    obs.counter_add("serve.reuse.dedup", float(collapsed), kind=kind)
        riders = ",".join(f"r{req.rid}" for req in group)
        t0 = time.monotonic()
        try:
            # the batch-level span carries the rider id list, so a trace
            # attributes shared batch time back to request ids and types;
            # the thread-local dispatch context carries the same identity
            # to the pluggable dispatcher (whose signature has no rids) so
            # a ClusterDispatcher can ship it to every worker's spans
            with _fleet.dispatch_context(
                riders=riders, kind=kind, generation=generation
            ), obs.span(
                "serve.dispatch",
                batch=len(group), kind=kind, riders=riders,
                generation=generation,
                collapsed=len(group) - len(payloads),
                **self._span_model(),
            ):
                results = self.retry_policy.run(
                    lambda: self._dispatch_group(kind, payloads, bound),
                    label="serve.dispatch",
                )
            if fan is not None:
                # copies per rider: co-riders of one collapsed payload
                # must never alias one mutable result object
                results = [
                    np.array(r) if isinstance(r, np.ndarray) else r
                    for r in (results[j] for j in fan)
                ]
        except Exception as exc:  # noqa: BLE001 — degrade to singletons
            logger.warning(
                "%s batch of %d failed (%s: %s); degrading to singleton "
                "requests", kind, len(group), type(exc).__name__, exc,
            )
            self._count("degraded_batches")
            obs.counter_add("serve.batch_degraded")
            self._run_singletons(group, bound)
            return
        done = time.monotonic()
        dispatch_s = done - t0
        self._note_dispatch(kind, dispatch_s)
        self._slo_dispatch(kind, len(group), dispatch_s, bound)
        self._cost_truth_dispatch(kind, len(group), dispatch_s, bound)
        for req, result in zip(group, results):
            if self._complete(req, result=result):
                self._finish(
                    req, done, dispatch_s=dispatch_s,
                    riders=len(group), generation=generation,
                )

    def _run_singletons(self, batch: list[_Request], bound=None) -> None:
        """Degraded mode: each rider re-dispatched alone — one bad
        request (or a transient that outlived its retries) fails only
        itself. ``bound`` pins the batch's program across the
        re-dispatches."""
        if bound is None:
            bound = self.bound
        with self._lock:
            generation = self._generation
        for req in batch:
            self._active_priority = req.priority
            t0 = time.monotonic()
            try:
                with _fleet.dispatch_context(
                    riders=f"r{req.rid}", kind=req.kind,
                    generation=generation,
                ), obs.span(
                    "serve.dispatch",
                    batch=1, kind=req.kind, riders=f"r{req.rid}",
                    generation=generation, degraded=1,
                    **self._span_model(),
                ):
                    results = self._dispatch_group(req.kind, [req.bits], bound)
            except Exception as exc:  # noqa: BLE001 — per-request verdict
                if self._complete(req, exc=exc):
                    self._count("failed")
                    self._count_type(req.kind, "failed")
                    obs.counter_add("serve.requests.failed")
                    obs.counter_add("serve.query.failed", type=req.kind)
                    self._slo_request(
                        req.kind, time.monotonic() - req.t_submit, "failed"
                    )
                    self._trace_request(req, "failed", degraded=True)
                continue
            done = time.monotonic()
            self._note_dispatch(req.kind, done - t0)
            self._slo_dispatch(req.kind, 1, done - t0, bound)
            self._cost_truth_dispatch(req.kind, 1, done - t0, bound)
            if self._complete(req, result=results[0]):
                self._finish(
                    req, done, dispatch_s=done - t0, riders=1,
                    generation=generation, degraded=True,
                )

    def _finish(
        self,
        req: _Request,
        done: float,
        dispatch_s: float = 0.0,
        riders: int = 1,
        generation: int = 0,
        degraded: bool = False,
    ) -> None:
        self._count("completed")
        self._count_type(req.kind, "completed")
        obs.counter_add("serve.requests.completed")
        obs.counter_add("serve.query.completed", type=req.kind)
        latency = done - req.t_submit
        tier = tier_of(req.kind)
        with self._lock:
            self._latencies.observe(latency)
            self._latencies_by_type[req.kind].observe(latency)
            self._ensure_tier(tier)
            self._latencies_by_tier[tier].observe(latency)
        obs.observe("serve.latency_s", latency)
        obs.observe("serve.query.latency_s", latency, type=req.kind)
        obs.observe("serve.tier.latency_s", latency, tier=tier)
        timeline = None
        if self._slo is not None or obs.enabled():
            timeline = self._timeline(
                req, "completed", latency, dispatch_s, riders, generation, degraded)
        if self._slo is not None:
            self._slo_request(req.kind, latency, "completed", timeline=timeline)
        if obs.enabled():
            self._trace_request(req, "completed", timeline=timeline)

    # -- per-request timeline ------------------------------------------------

    def _timeline(
        self, req: _Request, outcome: str, latency: float,
        dispatch_s: float = 0.0, riders: int = 1, generation: int = 0,
        degraded: bool = False,
    ) -> dict:
        """Plain-data per-request trace record: where this request's
        latency went (queue age -> batch wait -> its share of a
        ``riders``-wide dispatch) plus the serving context."""
        t_collect = req.t_collect or req.t_submit
        return {
            "rid": f"r{req.rid}",
            "type": req.kind,
            "outcome": outcome,
            "latency_s": round(latency, 6),
            "queue_age_s": round(max(t_collect - req.t_submit, 0.0), 6),
            "batch_wait_s": round(
                max(latency - (t_collect - req.t_submit) - dispatch_s, 0.0), 6
            ),
            "dispatch_s": round(dispatch_s, 6),
            "riders": riders,
            "generation": generation,
            "degraded": degraded,
            "plan_cached": bool(self.bound.plan),
        }

    def _trace_request(
        self, req: _Request, outcome: str, timeline: dict | None = None,
        degraded: bool = False,
    ) -> None:
        """Emit the request's terminal ``serve.request`` span (duration
        ~0; the timeline lives in the args), so a trace can be rolled up
        per request id and query type."""
        if not obs.enabled():
            return
        if timeline is None:
            timeline = self._timeline(
                req, outcome, time.monotonic() - req.t_submit, degraded=degraded)
        with obs.span("serve.request", **timeline):
            pass

    # -- SLO plumbing --------------------------------------------------------

    def _slo_request(
        self, kind: str, latency: float, outcome: str, timeline=None
    ) -> None:
        if self._slo is not None:
            self._slo.record_request(kind, latency, outcome, timeline=timeline)

    def _slo_dispatch(
        self, kind: str, batch: int, measured_s: float, bound: BoundProgram
    ) -> None:
        """Feed the drift detector one dispatch observation, bucketed by
        query type x power-of-two batch size. Kinds whose handler declares
        ``drift_stable = False`` (work varies with the payload, not the
        batch size: sampling's ``n_samples``, expectation's unique-term
        count) are excluded, and counted as excluded, so that workload mix
        never reads as drift."""
        if self._slo is None:
            return
        bucket = f"{kind}/b{batch_bucket(batch)}"
        handler = self._handlers.get(kind)
        if handler is not None and not getattr(handler, "drift_stable", True):
            exclude = getattr(self._slo, "record_dispatch_excluded", None)
            if exclude is not None:
                exclude(bucket)
            return
        self._slo.record_dispatch(
            bucket, self._predict_dispatch_s(kind, bound), measured_s
        )

    def _predict_dispatch_s(self, kind: str, bound: BoundProgram):
        """Calibrated prediction for one dispatch of ``kind`` under
        ``bound`` (None without a cost model, or for handler query types
        whose flops the service cannot see)."""
        if self.cost_model is None or kind != "amplitude":
            return None
        try:
            prof = self._bound_profile(bound)
            return self.cost_model.op_seconds(
                prof["flops"], dispatches=prof["steps"]
            )
        except Exception:  # noqa: BLE001 — prediction is best-effort
            return None

    #: minimum seconds between dispatcher-thread SLO evaluations (the burn
    #: windows are seconds to hours; the evaluation stays off the
    #: per-batch hot path)
    _SLO_CHECK_INTERVAL_S = 0.2

    def _slo_check(self) -> None:
        if self._slo is None:
            return
        now = time.monotonic()
        if now - self._slo_last_check < self._SLO_CHECK_INTERVAL_S:
            return
        self._slo_last_check = now
        alerts = self._slo.check()
        if self._cost_truth is not None and any(
            a.get("kind") == "drift" for a in alerts
        ):
            # the drift alert is the refit trigger (the refit's own
            # cooldown and hysteresis bound the reaction)
            self._cost_truth.maybe_refit(trigger="drift")

    # -- cost-truth loop -------------------------------------------------------

    def enable_cost_truth(
        self,
        registry=None,
        config=None,
        watch: bool = True,
        poll_interval_s: float = 0.25,
    ) -> "ContractionService":
        """Turn on the cost-truth loop (:mod:`tnc_tpu_torch.obs.cost_truth`):
        amplitude dispatches are reservoir-sampled by (kind x batch
        bucket), a drift alert triggers a hysteresis-bounded refit of the
        ``time ≈ flops/F + bytes/B + c`` model, accepted fits publish as
        versioned generations, and every pricing surface (drift
        predictions, replanner objective, router quotes) adopts a
        generation only at a batch boundary. A plan scoreboard records
        measured against predicted dispatch seconds; a freshly swapped
        plan that measures worse than the incumbent beyond tolerance rolls
        back.

        ``registry`` — a :class:`~tnc_tpu_torch.obs.cost_truth.ModelRegistry`
        or a directory for one; replicas sharing it converge on one
        generation (``watch=True`` polls it every ``poll_interval_s``
        seconds). ``config`` — a :class:`~tnc_tpu_torch.obs.cost_truth.
        CostTruthConfig`. ``TNC_TPU_COST_TRUTH=0`` suppresses the plane.

        An adopted generation never reaches the backend's own fit
        (:meth:`~tnc_tpu_torch.ops.backends.TorchBackend.cost_model`): the
        kernel policies, and ``policy_key()`` with the reuse store's key,
        keep naming the fit they were planned from."""
        from tnc_tpu_torch.obs import cost_truth as _ct

        cfg = _ct.config_from_env(config)
        if registry is not None and not isinstance(registry, _ct.ModelRegistry):
            registry = _ct.ModelRegistry(registry)
        ct = _ct.CostTruth(cfg, model=self.cost_model, registry=registry)
        self._cost_truth = ct
        if ct.model is not None and ct.model is not self.cost_model:
            # the registry's current generation outranks the constructor's
            # offline constants
            self._adopt_cost_model(ct.model_version, ct.model)
        elif ct.model_version:
            _fleet.set_flight_annotation(model_version=ct.model_version)
        if watch and registry is not None and cfg.enabled:
            watcher = _ct.ModelRegistryWatcher(
                self, registry, poll_interval_s=poll_interval_s
            )
            self._watchers.append(watcher)
            watcher.start()
        return self

    def _bound_profile(self, bound: BoundProgram) -> dict:
        """Derived per-bound constants (program flops, bytes and step
        count, plan-cache key, plan signature, scoreboard key), memoized
        by bound identity so the hot path never recomputes them."""
        prof = self._bound_profiles.get(id(bound))
        if prof is not None and prof["bound"] is bound:
            return prof
        from tnc_tpu_torch.ops.program import steps_bytes, steps_flops
        from tnc_tpu_torch.serve.plancache import network_structure_digest

        steps = bound.program.steps
        cache_key = network_structure_digest(
            bound.template.network, bound.target_size
        )
        sig = plan_signature(bound)
        prof = {
            "bound": bound,
            "flops": float(steps_flops(steps)),
            "bytes": float(steps_bytes(steps)),
            "steps": max(len(steps), 1),
            "cache_key": cache_key,
            "sig": sig,
            # scoreboard rows are per plan: an adopted swap scores apart
            # from its incumbent
            "score_key": f"{cache_key}:{sig[:12]}",
        }
        if len(self._bound_profiles) >= 8:
            self._bound_profiles.clear()
        self._bound_profiles[id(bound)] = prof
        return prof

    def _cost_truth_dispatch(
        self, kind: str, batch: int, dispatch_s: float, bound: BoundProgram
    ) -> None:
        """Feed the cost-truth plane one measured amplitude dispatch
        (sampler, scoreboard, post-swap watch); restage the prior plan
        when the watch's verdict is a regression."""
        ct = self._cost_truth
        if ct is None or kind != "amplitude":
            return
        try:
            prof = self._bound_profile(bound)
        except Exception:  # noqa: BLE001 — observability must not fail serving
            return
        verdict = ct.observe_dispatch(
            kind, batch, dispatch_s,
            flops=prof["flops"], nbytes=prof["bytes"], steps=prof["steps"],
            plan_key=prof["score_key"],
            predicted_s=self._predict_dispatch_s(kind, bound),
        )
        if verdict == "rollback":
            self._rollback_plan(prof)

    def _rollback_plan(self, prof: dict) -> None:
        """The adopted plan regressed inside its watch window: restage the
        prior bound (adopted at the next batch boundary) and pin the
        regressed plan's signature against re-adoption."""
        ct = self._cost_truth
        prior = ct.take_rollback()
        if prior is None:
            return
        with self._lock:
            self._pending_bound = prior
        obs.counter_add("serve.cost_truth.rollback")
        obs.counter_add("slo.alerts", kind="plan_rollback")
        logger.warning(
            "plan %s rolled back: measured dispatch seconds regressed "
            "past %.2fx its pre-swap baseline (%s)",
            prof["score_key"][:20], ct.config.rollback_tolerance,
            ct.last_rollback,
        )

    def _arm_swap_watch(
        self, new_bound: BoundProgram, prior_bound: BoundProgram | None
    ) -> None:
        """Start the regression watch for a just-adopted swap, against the
        incumbent's measured seconds (its prediction while the scoreboard
        is cold; with neither the swap is trusted)."""
        ct = self._cost_truth
        if ct is None or prior_bound is None:
            return
        try:
            prior_prof = self._bound_profile(prior_bound)
            new_prof = self._bound_profile(new_bound)
        except Exception:  # noqa: BLE001 — watch arming is best-effort
            return
        baseline = ct.scoreboard.measured_seconds(
            prior_prof["score_key"],
            min_samples=ct.config.scoreboard_min_samples,
        )
        if baseline is None and self.cost_model is not None:
            baseline = self.cost_model.op_seconds(
                prior_prof["flops"], dispatches=prior_prof["steps"]
            )
        if ct.arm_swap_watch(
            new_prof["score_key"], prior_bound, new_prof["sig"], baseline
        ):
            obs.counter_add("serve.cost_truth.swap_watch")

    def _adopt_cost_model(self, version: int, model) -> None:
        """A staged model generation becomes the one every pricing surface
        of the service reads — its drift predictions and quotes, the
        :class:`FidelityRouter`'s rung prices, the background replanner's
        seconds objective — adopted at a batch boundary. The backend's
        own fit, which its kernel policies were planned from and which
        ``policy_key()`` names, stays as it was."""
        self.cost_model = model
        if self._router is not None:
            self._router.cost_model = model
        replanner = self._replanner
        if replanner is not None:
            adopt = getattr(replanner, "adopt_cost_model", None)
            if adopt is not None:
                adopt(model)
        # stamped on every flight-recorder dump from now on
        _fleet.set_flight_annotation(model_version=version)
        obs.counter_add("serve.cost_truth.model_adopted")
        logger.info(
            "adopted cost-model generation v%d (%.3e flops/s, "
            "%.1e s/dispatch)", version, model.flops_per_s, model.dispatch_s,
        )

    def measured_plan_seconds(self) -> float | None:
        """Measured mean dispatch seconds of the serving plan from the
        scoreboard (None while cold or without cost truth) — the
        replanner's measured-incumbent margin input."""
        ct = self._cost_truth
        if ct is None:
            return None
        try:
            prof = self._bound_profile(self.bound)
        except Exception:  # noqa: BLE001 — pricing input is best-effort
            return None
        return ct.scoreboard.measured_seconds(
            prof["score_key"], min_samples=ct.config.scoreboard_min_samples
        )

    def _span_model(self) -> dict:
        """Span kwargs stamping the active model generation (empty
        without cost truth)."""
        ct = self._cost_truth
        return {} if ct is None else {"model_version": ct.model_version}

    # -- stats -------------------------------------------------------------

    # every terminal outcome increments its per-type row — deadline
    # expiry, queue rejection and caller-side cancellation included
    _TYPE_KEYS = (
        "submitted", "completed", "failed", "expired", "rejected",
        "cancelled", "batches",
    )

    # per-tier rows additionally audit the escalation ladder
    _TIER_KEYS = _TYPE_KEYS + ("escalated", "escalation_capped")

    def _ensure_type(self, kind: str) -> dict:
        row = self._by_type.get(kind)
        if row is None:
            row = {k: 0 for k in self._TYPE_KEYS}
            self._by_type[kind] = row
            self._latencies_by_type[kind] = QuantileSummary()
        return row

    def _ensure_tier(self, tier: str) -> dict:
        row = self._by_tier.get(tier)
        if row is None:
            row = {k: 0 for k in self._TIER_KEYS}
            self._by_tier[tier] = row
            self._latencies_by_tier[tier] = QuantileSummary()
            self._tier_dispatch[tier] = [0, 0.0]  # dispatches, seconds
        return row

    def _count(self, key: str) -> None:
        with self._lock:
            self._counts[key] += 1

    def _count_type(self, kind: str, key: str) -> None:
        tier = tier_of(kind)
        with self._lock:
            self._ensure_type(kind)[key] += 1
            self._ensure_tier(tier)[key] += 1
        obs.counter_add(f"serve.tier.{key}", tier=tier)

    def _note_dispatch(self, kind: str, dispatch_s: float) -> None:
        """Measured dispatch seconds, accumulated per tier."""
        tier = tier_of(kind)
        with self._lock:
            row = self._tier_dispatch[tier]
            row[0] += 1
            row[1] += dispatch_s
        obs.observe("serve.tier.dispatch_s", dispatch_s, tier=tier)

    def note_escalation(self, base: str, capped: bool = False) -> None:
        """The router's escalation audit hook: counted per tier and as
        ``serve.tier.escalated`` / ``serve.tier.escalation_capped``
        (``capped`` = the escalation budget was exhausted and the approx
        answer was served with ``tolerance_met=False``)."""
        key = "escalation_capped" if capped else "escalated"
        with self._lock:
            self._ensure_tier("approx")[key] += 1
        obs.counter_add(f"serve.tier.{key}", tier="approx", kind=base)

    def reset_stats(self) -> None:
        """Zero the in-memory counts and samples (after a warm-up, so
        that first-call costs never skew the published distribution)."""
        with self._lock:
            for key in self._counts:
                self._counts[key] = 0
            self._batch_sizes.clear()
            self._latencies = QuantileSummary()
            for kind, row in self._by_type.items():
                for key in row:
                    row[key] = 0
                self._latencies_by_type[kind] = QuantileSummary()
            for tier, row in self._by_tier.items():
                for key in row:
                    row[key] = 0
                self._latencies_by_tier[tier] = QuantileSummary()
                self._tier_dispatch[tier] = [0, 0.0]
        # the router's escalation audit (and its max_escalations budget)
        # covers the same window as the tier rows
        if self._router is not None:
            self._router.reset()

    @staticmethod
    def _latency_block(summary: QuantileSummary) -> dict:
        """Percentile block from a streaming summary."""
        return {
            "count": summary.count,
            "p50": round(summary.quantile(0.5), 6),
            "p90": round(summary.quantile(0.9), 6),
            "p99": round(summary.quantile(0.99), 6),
            "max": round(summary.max, 6),
        }

    def stats(self) -> dict:
        """Snapshot: request counts, batch-size distribution, latency
        percentiles, the per-query-type breakdown (``by_type``), the
        per-fidelity-tier breakdown (``by_tier``: counts — escalations
        included — latency percentiles and measured dispatch seconds),
        and the reuse store's and plan cache's counts when attached."""
        # percentile blocks are computed UNDER the lock: the summaries are
        # live objects the dispatcher observes into
        with self._lock:
            counts = dict(self._counts)
            sizes = list(self._batch_sizes)
            latency = self._latency_block(self._latencies)
            by_type = {
                kind: {
                    "counts": dict(row),
                    "latency_s": self._latency_block(self._latencies_by_type[kind]),
                }
                for kind, row in self._by_type.items()
            }
            by_tier = {
                tier: {
                    "counts": dict(row),
                    "latency_s": self._latency_block(self._latencies_by_tier[tier]),
                    "dispatch": {
                        "count": self._tier_dispatch[tier][0],
                        "total_s": round(self._tier_dispatch[tier][1], 6),
                        "mean_s": round(
                            self._tier_dispatch[tier][1]
                            / max(self._tier_dispatch[tier][0], 1),
                            6,
                        ),
                    },
                }
                for tier, row in self._by_tier.items()
            }
        if self._router is not None:
            by_tier["approx"]["router"] = self._router.describe()
        out = {
            "counts": counts,
            "batch_size": {
                "count": len(sizes),
                "min": int(min(sizes)) if sizes else 0,
                "max": int(max(sizes)) if sizes else 0,
                "mean": float(np.mean(sizes)) if sizes else 0.0,
            },
            "latency_s": latency,
            "by_type": by_type,
            "by_tier": by_tier,
        }
        store = self._effective_reuse_store()
        if store is not None:
            out["reuse"] = store.stats()
        if self._plan_cache is not None:
            out["plan_cache"] = self._plan_cache.stats()
        if self._slo is not None:
            out["slo"] = self._slo.stats()
        if self._plansvc is not None:
            out["plansvc"] = self._plansvc.stats()
        if self._cost_truth is not None:
            out["calibration"] = self._cost_truth.stats()
        if self._elastic is not None:
            from tnc_tpu_torch.serve import elastic as _elastic_mod

            out["elastic"] = {
                "counters": _elastic_mod.counters(),
                "tenants": self._tenant_depths(),
                "weights": dict(self._elastic.tenant_weights),
                "quotas": dict(self._elastic.tenant_quotas),
                "controller": (
                    dict(self._elastic_controller.last_decision)
                    if self._elastic_controller is not None else None
                ),
            }
        return out

    def _effective_reuse_store(self):
        """The intermediate-tensor store serving this service's bound
        program (attached via from_circuit, or carried by a bound built
        directly with ``bind_template(..., reuse_store=)``)."""
        if self.reuse_store is not None:
            return self.reuse_store
        reuse = getattr(self.bound, "reuse", None)
        return reuse.store if reuse is not None else None

    # -- live telemetry endpoint -------------------------------------------

    def serve_telemetry(self, host: str = "127.0.0.1", port: int = 0):
        """Start (and own) the scrape endpoint of this service:
        ``/metrics`` (Prometheus text: the obs registry and the service's
        own families, percentile-identical to ``stats()``), ``/healthz``,
        ``/slo``, ``/calibration`` and ``/fleet`` (the federated view once
        :meth:`attach_fleet` ran, else ``{"enabled": false}``). Returns the
        started
        :class:`~tnc_tpu_torch.obs.http.TelemetryServer` (``.port`` is the
        bound port when ``port=0``); :meth:`stop` shuts it down and
        releases the port. The server's thread reads host counters only."""
        from tnc_tpu_torch.obs.http import TelemetryServer

        if self._telemetry is not None:
            return self._telemetry

        def health() -> dict:
            running = self._running
            body = {
                "status": "ok" if running else "stopped",
                "running": running,
                "queue_depth": self.queue_depth() if running else 0,
                "replica": _fleet.replica_identity(),
            }
            if self._fleet_registry is not None:
                body["heartbeat_age_s"] = (
                    self._fleet_registry.last_heartbeat_age_s()
                )
            return body

        def slo() -> dict:
            if self._slo is None:
                return {"enabled": False}
            body = self._slo.stats()
            body["enabled"] = True
            body["recent_requests"] = self._slo.timelines()[-32:]
            return body

        def fleet() -> dict:
            # late-bound: attach_fleet may run after serve_telemetry
            if self._fleet_aggregator is None:
                return {"enabled": False}
            body = self._fleet_aggregator.snapshot()
            body["enabled"] = True
            return body

        def calibration() -> dict:
            # late-bound: enable_cost_truth may run after serve_telemetry
            if self._cost_truth is None:
                return {"enabled": False}
            return self._cost_truth.stats()

        self._telemetry = TelemetryServer(
            registry=obs.get_registry(),
            host=host,
            port=port,
            health_fn=health,
            slo_fn=slo,
            extra_metrics_fn=self._prometheus_families,
            fleet_fn=fleet,
            calibration_fn=calibration,
        ).start()
        return self._telemetry

    # -- fleet observability plane ------------------------------------------

    def attach_fleet(
        self,
        directory: str | None = None,
        endpoints=(),
        heartbeat_s: float = 2.0,
        name: str | None = None,
        stale_after_s: float = 10.0,
    ) -> None:
        """Join the fleet observability plane (a re-attach replaces the
        previous membership).

        ``directory`` — the shared :class:`~tnc_tpu_torch.obs.fleet.
        FleetRegistry` directory: this replica heartbeats its identity,
        queue depth, SLO-alert/drift state, planner-pod state and scrape URL
        every ``heartbeat_s`` seconds, and the roster (with
        join/stale/leave transitions) rides the ``/fleet`` body.
        ``endpoints`` — extra ``{name: url}`` scrape targets (replicas
        outside the registry). The root's own metrics are read in-process
        (no HTTP round-trip to itself). See
        :class:`~tnc_tpu_torch.obs.fleet.FleetAggregator`."""
        if self._fleet_heartbeat is not None:
            self._fleet_heartbeat.stop()
            self._fleet_heartbeat = None
        registry = None
        if directory is not None:
            registry = _fleet.FleetRegistry(
                directory, name=name, stale_after_s=stale_after_s
            )

            def provider() -> dict:
                payload = {
                    "role": "root",
                    "queue_depth": self.queue_depth(),
                    "url": (
                        self._telemetry.url
                        if self._telemetry is not None else None
                    ),
                }
                if self._slo is not None:
                    slo_stats = self._slo.stats()
                    payload["slo_alerts"] = len(slo_stats.get("alerts", ()))
                    payload["slo_alerts_total"] = slo_stats.get(
                        "alerts_total", 0
                    )
                    drift = slo_stats.get("drift", {})
                    payload["drift_alerting"] = sum(
                        1 for row in drift.values()
                        if isinstance(row, dict) and row.get("alerting")
                    )
                    # worst live measured/predicted ratio across drift
                    # buckets: the fleet view's at-a-glance column
                    ratios = [
                        row["ratio"] for row in drift.values()
                        if isinstance(row, dict)
                        and row.get("ratio") is not None
                    ]
                    if ratios:
                        payload["drift_ratio"] = round(
                            max(ratios, key=lambda r: abs(r - 1.0)), 4
                        )
                if self._cost_truth is not None:
                    payload["model_version"] = self._cost_truth.model_version
                if self._plansvc is not None:
                    # planner columns: role, trials completed here, last
                    # merge's cost delta
                    payload["plansvc"] = self._plansvc.heartbeat_payload()
                if self._elastic is not None:
                    from tnc_tpu_torch.serve import elastic as _elastic_mod

                    payload["tenants"] = self._tenant_depths()
                    payload["elastic"] = _elastic_mod.counters()
                # the cluster dispatcher's last per-process range
                # assignment (the fleet view's assignment column)
                assignment = getattr(self.dispatcher, "last_ranges", None)
                if assignment is not None:
                    payload["assignment"] = [list(r) for r in assignment]
                return payload

            self._fleet_registry = registry
            self._fleet_heartbeat = _fleet.Heartbeat(
                registry, provider=provider, interval_s=heartbeat_s
            ).start()

        def local_render() -> str:
            if self._telemetry is not None:
                return self._telemetry.render_metrics()
            from tnc_tpu_torch.obs.http import render_prometheus

            return render_prometheus(
                obs.get_registry(), self._prometheus_families()
            )

        local_name = name if name is not None else _fleet.replica_name()
        self._fleet_aggregator = _fleet.FleetAggregator(
            endpoints=endpoints,
            registry=registry,
            local=(local_name, local_render),
        )

    def fleet_snapshot(self) -> dict | None:
        """The federated fleet view (same body as ``/fleet``), or None
        before :meth:`attach_fleet`."""
        if self._fleet_aggregator is None:
            return None
        return self._fleet_aggregator.snapshot()

    def _prometheus_families(self) -> list:
        """The service's own metric families for ``/metrics`` — computed
        from the same counters and quantile summaries ``stats()`` reads
        (snapshotted under the lock), whether or not obs tracing is on."""
        with self._lock:
            counts = dict(self._counts)
            overall = (
                self._latency_block(self._latencies),
                self._latencies.sum,
            )
            by_type = {
                kind: (
                    dict(row),
                    self._latency_block(self._latencies_by_type[kind]),
                    self._latencies_by_type[kind].sum,
                )
                for kind, row in self._by_type.items()
            }
        fams: list = [("gauge", "serve.queue_depth", {}, self.queue_depth())]
        # request outcomes get their own family, so that
        # sum(serve_requests_total) is a true request count
        for key in ("submitted", "completed", "failed", "expired", "rejected",
                    "cancelled"):
            fams.append(("counter", "serve.requests", {"outcome": key}, counts[key]))
        fams.append(("counter", "serve.batches", {}, counts["batches"]))
        fams.append(("counter", "serve.batches_degraded", {}, counts["degraded_batches"]))
        fams.append(("counter", "serve.plan_swaps", {}, counts["plan_swaps"]))
        fams.append(("counter", "serve.dedup_collapsed", {}, counts["deduped"]))
        store = self._effective_reuse_store()
        if store is not None:
            reuse_stats = store.stats()
            for key in store.COUNT_KEYS:
                fams.append(("counter", "serve.reuse", {"event": key}, reuse_stats[key]))
            fams.append(("gauge", "serve.reuse.bytes_held", {}, reuse_stats["bytes_held"]))
            fams.append(("gauge", "serve.reuse.entries", {}, reuse_stats["entries"]))
            fams.append(("counter", "serve.reuse.prefix_flops_saved", {},
                         reuse_stats["prefix_flops_saved"]))
        if self._plan_cache is not None:
            for key, value in self._plan_cache.stats()["counts"].items():
                fams.append(("counter", "serve.plan_cache", {"event": key}, value))
        if self._plansvc is not None:
            svc_stats = self._plansvc.stats()
            for key, value in sorted(svc_stats["counts"].items()):
                fams.append(("counter", "serve.plansvc.events", {"event": key}, value))
            for key, value in sorted(svc_stats["board"].items()):
                fams.append(("counter", "serve.plansvc.board", {"event": key}, value))
            fams.append(("gauge", "serve.plansvc.best_delta", {}, svc_stats["best_delta"]))

        def summary(name: str, labels: dict, block: dict, total: float):
            for q, qlabel in (("p50", "0.5"), ("p90", "0.9"), ("p99", "0.99")):
                fams.append(("summary", name, {**labels, "quantile": qlabel}, block[q]))
            fams.append(("summary", f"{name}_count", labels, block["count"]))
            fams.append(("summary", f"{name}_sum", labels, total))
            fams.append(("gauge", f"{name}_max", labels, block["max"]))

        summary("serve.latency_seconds", {}, *overall)
        for kind, (row, block, total) in by_type.items():
            for key, value in row.items():
                if key == "batches":
                    fams.append(("counter", "serve.type_batches", {"type": kind}, value))
                else:
                    fams.append(("counter", "serve.type_requests",
                                 {"type": kind, "outcome": key}, value))
            summary("serve.type_latency_seconds", {"type": kind}, block, total)
        with self._lock:
            tier_rows = {t: dict(r) for t, r in self._by_tier.items()}
        for tier, row in tier_rows.items():
            for key, value in row.items():
                if key == "batches":
                    fams.append(("counter", "serve.tier_batches", {"tier": tier}, value))
                else:
                    fams.append(("counter", "serve.tier_requests",
                                 {"tier": tier, "outcome": key}, value))
        if self._elastic is not None:
            from tnc_tpu_torch.serve import elastic as _elastic_mod

            # serve_elastic_*: the elastic event ledger (reassigned,
            # preempted, scale decisions), per-tenant queue depths and the
            # controller's target — the numbers of stats()["elastic"], so
            # /metrics and /fleet federate them
            for event, value in sorted(_elastic_mod.counters().items()):
                fams.append(("counter", "serve.elastic.events", {"event": event},
                             float(value)))
            for tenant, depth in sorted(self._tenant_depths().items()):
                fams.append(("gauge", "serve.elastic.tenant_queue", {"tenant": tenant},
                             float(depth)))
            ctrl = self._elastic_controller
            if ctrl is not None:
                fams.append(("gauge", "serve.elastic.scale_target", {},
                             float(ctrl.last_decision.get("target", 0))))
        ct = self._cost_truth
        if ct is not None:
            # the live model generation, the loop's event ledger and the
            # sampler's reservoir fill: the numbers of stats()["calibration"]
            cal = ct.stats()
            fams.append(("gauge", "serve.cost_truth.model_version", {},
                         float(cal["model_version"])))
            for event, value in sorted(cal["counts"].items()):
                fams.append(("counter", "serve.cost_truth.events", {"event": event},
                             float(value)))
            fams.append(("gauge", "serve.cost_truth.sampler_kept", {},
                         float(cal["sampler"]["kept"])))
        return fams


@dataclass(frozen=True)
class ApproxAnswer:
    """What an ``rtol=`` request resolves to: the value with an honest
    per-answer error estimate.

    ``err`` bounds ``|value − exact|`` (the chi-ladder's estimate, or
    a pure roundoff margin for escalated/untruncated answers);
    ``chi_used`` is the converged rung's bond dimension (None for an
    escalated exact answer); ``tolerance_met`` is False only when the
    escalation budget was exhausted and the best approximate answer was
    served anyway; ``sweeps`` counts the ladder rungs executed."""

    value: complex
    err: float
    chi_used: int | None
    escalated: bool = False
    tolerance_met: bool = True
    sweeps: int = 0


class FidelityRouter:
    """Routes tolerant requests onto the boundary-MPS chi-ladder tier
    and escalates tolerance misses to the exact pipeline.

    Registered as the ``"approx"`` query handler: ``validate`` checks
    the payload per base kind (amplitude / expectation / marginal) and
    assigns the ``(approx, base)`` batching key — approx work shares
    the queue but never a batch with exact work; ``dispatch`` runs the
    :class:`~tnc_tpu_torch.approx.ladder.ChiLadder` per request against the
    structure-shared :class:`~tnc_tpu_torch.approx.program.ApproxProgram`
    grids (amplitude grid for amplitudes, ONE sandwich grid for
    expectation and marginal — per-request payloads are leaf-data
    rebinds). On a :class:`~tnc_tpu_torch.ops.backends.TorchBackend` the
    sweeps run ``backend="torch"`` in its dtype on its device; on any
    other backend ``"numpy"`` (complex128 on the host).

    A ladder that cannot meet the requested tolerance **escalates**:
    the request is re-answered by the exact pipeline (the service's
    bound program / registered query handlers), counted per tier and
    as ``serve.tier.escalated``, under a ``serve.escalate`` span, and
    capped at ``max_escalations`` — past the cap the approximate
    answer is served with ``tolerance_met=False``. An escalated answer's
    error bar is the exact pipeline's roundoff floor:
    :data:`~tnc_tpu_torch.approx.ladder.COMPLEX64_ERR_REL` on every
    ``TorchBackend`` (its products run in FP32 whatever the dtype),
    :data:`~tnc_tpu_torch.approx.ladder.EXACT_ERR_REL` otherwise.

    ``cost_model`` (a :class:`~tnc_tpu_torch.obs.calibrate.
    CalibratedCostModel`) prices every ladder rung in predicted seconds
    (:mod:`tnc_tpu_torch.approx.cost`), so :meth:`describe` quotes
    approximate-tier latency.
    """

    kind = APPROX_KIND
    # work per dispatch varies with each request's ladder climb, not the
    # batch size: the SLO drift detector does not track this kind
    drift_stable = False

    BASES = ("amplitude", "expectation", "marginal")

    #: tolerance scale per base kind: the tolerance is relative to
    #: ``max(|value|, scale)`` — an amplitude's natural magnitude is
    #: ``2^(-n/2)``, expectation values and probabilities are O(1)
    _UNIT_SCALE = 1.0

    def __init__(
        self,
        service: ContractionService,
        circuit,
        chis=None,
        chi_start: int = 2,
        chi_cap: int = 64,
        safety: float = 4.0,
        max_escalations: int = 256,
        cost_model=None,
    ) -> None:
        from tnc_tpu_torch.approx import ApproxProgram, ChiLadder

        self._service = service
        self._circuit = circuit.copy()
        self.num_qubits = self._circuit.num_qubits()
        self.ladder = ChiLadder(
            chis=chis, chi_start=chi_start, chi_cap=chi_cap, safety=safety
        )
        self.cost_model = (
            cost_model if cost_model is not None else service.cost_model
        )
        self.max_escalations = int(max_escalations)
        self.escalations = 0
        self.escalations_capped = 0
        self._programs: dict[str, object] = {}
        self._exact_programs: dict = {}
        # build the amplitude grid eagerly: a circuit the tier cannot
        # flatten (non-nearest-neighbour) must fail at attach time, not
        # on the first tolerant request
        self._programs["amplitude"] = ApproxProgram.from_circuit(self._circuit)

    # -- programs ----------------------------------------------------------

    def program(self, base: str):
        """The grid program serving ``base`` (expectation and marginal
        share the sandwich grid)."""
        from tnc_tpu_torch.approx import ApproxProgram

        key = "amplitude" if base == "amplitude" else "sandwich"
        prog = self._programs.get(key)
        if prog is None:
            prog = ApproxProgram.sandwich_from_circuit(self._circuit)
            self._programs[key] = prog
        return prog

    def _scale(self, base: str) -> float:
        if base == "amplitude":
            return 2.0 ** (-self.num_qubits / 2.0)
        return self._UNIT_SCALE

    # -- handler protocol --------------------------------------------------

    def validate(self, payload) -> tuple[dict, tuple]:
        from tnc_tpu_torch.builders.circuit_builder import normalize_bitstring

        payload = dict(payload)
        base = payload.get("kind")
        if base not in self.BASES:
            raise ValueError(f"approx tier serves {self.BASES}, not {base!r}")
        rtol = float(payload.get("rtol", 0.0))
        if not rtol > 0.0:
            raise ValueError(f"rtol must be > 0, got {rtol}")
        raw = payload.get("payload")
        if base == "amplitude":
            bits = normalize_bitstring(raw, self.num_qubits)
            if "*" in bits:
                raise ValueError(
                    "approx amplitude requests must be fully determined "
                    "(no '*' positions)"
                )
            validated = bits
        elif base == "expectation":
            from tnc_tpu_torch.queries.expectation import normalize_terms

            validated = normalize_terms(raw, self.num_qubits)
        else:
            validated = normalize_bitstring(raw, self.num_qubits)
        return (
            {"kind": base, "payload": validated, "rtol": rtol},
            (self.kind, base),
        )

    def dispatch(self, payloads, backend) -> list:
        with obs.span("serve.handler", type=self.kind, batch=len(payloads)):
            return [self._one(p, backend) for p in payloads]

    # -- the ladder + escalation path --------------------------------------

    def _climb(self, prog, rtol: float, scale: float, backend):
        """One ladder climb of ``prog``'s current binding on the sweep the
        service's backend names."""
        if isinstance(backend, TorchBackend):
            return self.ladder.run(
                prog, rtol, scale=scale, backend="torch", cost_model=self.cost_model,
                dtype=str(backend.dtype), device=backend.device,
            )
        return self.ladder.run(prog, rtol, scale=scale, backend="numpy",
                               cost_model=self.cost_model)

    def _one(self, payload: dict, backend) -> ApproxAnswer:
        base = payload["kind"]
        raw = payload["payload"]
        rtol = payload["rtol"]
        if base == "expectation":
            return self._one_expectation(raw, rtol, backend)
        prog = self.program(base)
        if base == "amplitude":
            prog.rebind_bits(raw)
        else:
            prog.rebind_projectors(raw)
        res = self._climb(prog, rtol, self._scale(base), backend)
        value = res.value if base != "marginal" else res.value.real
        if res.converged:
            return ApproxAnswer(value, res.err, res.chi_used, sweeps=res.sweeps)
        return self._escalate(
            base, raw, value, res.err, res.chi_used, res.sweeps, backend, rtol,
        )

    def _one_expectation(self, terms, rtol: float, backend) -> ApproxAnswer:
        """A Pauli sum rides one sandwich grid: one ladder climb per
        UNIQUE Pauli string, coefficient-weighted combination, summed
        error bars."""
        prog = self.program("expectation")
        unique: dict[str, object] = {}
        for _c, pauli in terms:
            if pauli not in unique:
                prog.rebind_pauli(pauli)
                unique[pauli] = self._climb(prog, rtol, self._scale("expectation"),
                                            backend)
        value = complex(sum(c * unique[p].value for c, p in terms))
        err = float(sum(abs(c) * unique[p].err for c, p in terms))
        chi_used = max(r.chi_used for r in unique.values())
        sweeps = sum(r.sweeps for r in unique.values())
        converged = all(r.converged for r in unique.values()) and (
            err <= rtol * max(abs(value), self._UNIT_SCALE)
        )
        if converged:
            return ApproxAnswer(value, err, chi_used, sweeps=sweeps)
        return self._escalate(
            "expectation", terms, value, err, chi_used, sweeps, backend, rtol,
        )

    @staticmethod
    def exact_floor(backend) -> float:
        """The relative roundoff floor of the exact pipeline on
        ``backend``: :data:`~tnc_tpu_torch.approx.ladder.COMPLEX64_ERR_REL`
        on every ``TorchBackend`` (FP32 products whatever the dtype),
        :data:`~tnc_tpu_torch.approx.ladder.EXACT_ERR_REL` otherwise.

        >>> from tnc_tpu_torch.ops.backends import NumpyBackend
        >>> FidelityRouter.exact_floor(TorchBackend(device="cpu", dtype="complex128"))
        0.0001
        >>> FidelityRouter.exact_floor(NumpyBackend())
        1e-09
        """
        from tnc_tpu_torch.approx.ladder import COMPLEX64_ERR_REL, EXACT_ERR_REL

        return COMPLEX64_ERR_REL if isinstance(backend, TorchBackend) else EXACT_ERR_REL

    def _escalate(
        self, base, raw, value, err, chi_used, sweeps, backend, rtol
    ) -> ApproxAnswer:
        if self.escalations >= self.max_escalations:
            self.escalations_capped += 1
            self._service.note_escalation(base, capped=True)
            logger.warning(
                "approx %s miss (err=%.3g > rtol=%.3g) but the "
                "escalation budget (%d) is exhausted; serving the "
                "approximate answer", base, err, rtol, self.max_escalations,
            )
            return ApproxAnswer(
                value, err, chi_used, tolerance_met=False, sweeps=sweeps
            )
        self.escalations += 1
        self._service.note_escalation(base)
        with obs.span("serve.escalate", kind=base, rtol=rtol):
            exact = self._exact_value(base, raw, backend)
        return ApproxAnswer(
            exact,
            self.exact_floor(backend) * max(abs(exact), self._scale(base)),
            None,
            escalated=True,
            sweeps=sweeps,
        )

    def _exact_value(self, base: str, raw, backend):
        """The exact pipeline's answer for an escalated request —
        through the service's registered query handler when present
        (shared plan cache), else through a lazily-bound exact program
        of the router's own circuit copy."""
        if base == "amplitude":
            return complex(self._service.bound.amplitudes([raw], backend)[0])
        handler = self._service._handlers.get(base)
        if handler is not None:
            return handler.dispatch([raw], backend)[0]
        if base == "expectation":
            prog = self._exact_programs.get("expectation")
            if prog is None:
                from tnc_tpu_torch.queries.expectation import bind_expectation

                prog = bind_expectation(self._circuit.copy())
                self._exact_programs["expectation"] = prog
            unique = sorted({p for _c, p in raw})
            vals = dict(zip(unique, prog.values(unique, backend)))
            return complex(sum(c * vals[p] for c, p in raw))
        from tnc_tpu_torch.queries.marginal import (
            bind_marginal,
            marginal_probabilities,
            wildcard_mask,
        )

        mask = wildcard_mask(raw)
        bound = self._exact_programs.get(("marginal", mask))
        if bound is None:
            bound = bind_marginal(self._circuit.copy(), mask)
            self._exact_programs[("marginal", mask)] = bound
        return float(np.asarray(marginal_probabilities(bound, [raw], backend))[0])

    def reset(self) -> None:
        """Zero the escalation audit (and re-arm the budget) — called by
        :meth:`ContractionService.reset_stats`."""
        self.escalations = 0
        self.escalations_capped = 0

    # -- quoting -----------------------------------------------------------

    def quote_seconds(self, base: str = "amplitude") -> float | None:
        """Predicted seconds of a full ladder climb for ``base`` under
        the calibrated cost model (None without one)."""
        if self.cost_model is None:
            return None
        from tnc_tpu_torch.approx.cost import ladder_seconds

        prog = self.program(base)
        return ladder_seconds(prog, self.ladder.rungs_for(prog), self.cost_model)

    def describe(self) -> dict:
        """Router posture for ``stats()["by_tier"]["approx"]``:
        escalation budget audit + per-base-kind rung schedule and
        latency quotes."""
        out = {
            "escalations": self.escalations,
            "escalations_capped": self.escalations_capped,
            "max_escalations": self.max_escalations,
            "rungs": {},
            "quote_s": {},
        }
        for base in ("amplitude", "sandwich"):
            prog = self._programs.get(base)
            if prog is None:
                continue
            out["rungs"][base] = list(self.ladder.rungs_for(prog))
            quote = (
                self.quote_seconds("amplitude" if base == "amplitude" else "marginal")
                if self.cost_model is not None
                else None
            )
            out["quote_s"][base] = round(quote, 6) if quote is not None else None
        return out
