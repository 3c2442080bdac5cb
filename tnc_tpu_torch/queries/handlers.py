"""Query handlers: sampling / expectation / marginal requests on a
:class:`~tnc_tpu_torch.serve.service.ContractionService` (the port's copy
of ``tnc_tpu.queries.handlers``).

The service owns the queue, micro-batching window, deadlines,
admission control, retry and degradation; a handler owns one query
TYPE — payload validation at submit time, the per-type batching key
(a batch never mixes structures), and the batched dispatch. All
handler structures plan through :func:`~tnc_tpu_torch.serve.rebind.
bind_template` with the service's plan cache, so repeat structures
are cache hits with zero pathfinding, exactly like amplitude serving.

Attach with :func:`attach_query_handlers` (or
``ContractionService.from_circuit(..., queries=True)``):

>>> from tnc_tpu_torch.ops.backends import NumpyBackend
>>> from tnc_tpu_torch.serve import ContractionService
>>> from tnc_tpu_torch.tensornetwork.tensordata import TensorData
>>> c = Circuit(); reg = c.allocate_register(2)
>>> c.append_gate(TensorData.gate("x"), [reg.qubit(0)])
>>> with ContractionService.from_circuit(c, queries=True,
...                                      backend=NumpyBackend()) as svc:
...     samples = svc.sample(2, seed=0)
...     ev = svc.expectation("zi")
...     p = svc.marginal("1*")
>>> samples, complex(ev), round(p, 6)
(['10', '10'], (-1+0j), 1.0)
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from tnc_tpu_torch import obs
from tnc_tpu_torch.builders.circuit_builder import Circuit, normalize_bitstring
from tnc_tpu_torch.queries.expectation import (
    ExpectationProgram,
    bind_expectation,
    normalize_terms,
)
from tnc_tpu_torch.queries.marginal import (
    bind_marginal,
    marginal_probabilities,
    wildcard_mask,
)
from tnc_tpu_torch.queries.sampling import ChainSampler

__all__ = [
    "SampleQueryHandler",
    "ExpectationQueryHandler",
    "MarginalQueryHandler",
    "attach_query_handlers",
]


class SampleQueryHandler:
    """``kind="sample"``: payload ``{"n_samples": int, "seed": ...}`` →
    a list of sampled bitstrings. Co-batched requests share every
    chain step's conditional dispatch (distinct prefixes across ALL
    in-flight samples dedupe into one rebind batch) while each request
    draws from its own seeded RNG — results are independent of who
    rides along."""

    kind = "sample"
    # per-dispatch work scales with each request's n_samples, not the
    # batch size: measured seconds per batch-size bucket are not
    # comparable, so the SLO drift detector does not track this kind
    drift_stable = False
    # stochastic: two requests with equal payloads but distinct seeds
    # (or seed=None) must draw independently — the dispatcher's
    # queue-level dedup never collapses sample riders
    dedup_payloads = False

    def __init__(self, sampler: ChainSampler) -> None:
        self.sampler = sampler

    def validate(self, payload) -> tuple[dict, tuple]:
        if isinstance(payload, int):
            payload = {"n_samples": payload}
        payload = dict(payload)
        n_samples = int(payload.pop("n_samples", 1))
        if n_samples < 1:
            raise ValueError("n_samples must be >= 1")
        seed = payload.pop("seed", None)
        if payload:
            raise ValueError(
                f"unknown sample payload keys: {sorted(payload)}"
            )
        return {"n_samples": n_samples, "seed": seed}, (self.kind,)

    def dispatch(self, payloads: Sequence[dict], backend) -> list:
        # the per-type timeline tag: the handler's whole batched
        # execution nests under the service's `serve.dispatch` span, so
        # a trace rollup attributes chain-step time to the query type
        with obs.span("serve.handler", type=self.kind, batch=len(payloads)):
            return self.sampler.sample_groups(
                [(p["n_samples"], p["seed"]) for p in payloads], backend
            )


class ExpectationQueryHandler:
    """``kind="expectation"``: payload = a Pauli string or an iterable
    of ``(coeff, pauli)`` terms → the (complex) expectation value. All
    requests share ONE sandwich structure; the union of all co-batched
    requests' distinct Pauli strings dispatches as one observable-leaf
    rebind batch."""

    kind = "expectation"
    # per-dispatch work scales with the unique Pauli strings across the
    # batch: not drift-comparable per batch-size bucket
    drift_stable = False
    # deterministic in the payload (normalized term tuples are
    # hashable): identical riders in one window collapse to a single
    # dispatch entry
    dedup_payloads = True

    def __init__(
        self,
        circuit: Circuit,
        pathfinder=None,
        plan_cache=None,
        target_size: float | None = None,
    ) -> None:
        self._circuit = circuit.copy()
        self.num_qubits = self._circuit.num_qubits()
        self.pathfinder = pathfinder
        self.plan_cache = plan_cache
        self.target_size = target_size
        self._program: ExpectationProgram | None = None

    def program(self) -> ExpectationProgram:
        if self._program is None:
            self._program = bind_expectation(
                self._circuit.copy(),
                self.pathfinder,
                self.plan_cache,
                self.target_size,
            )
        return self._program

    def validate(self, payload) -> tuple[tuple, tuple]:
        return normalize_terms(payload, self.num_qubits), (self.kind,)

    def dispatch(self, payloads: Sequence[tuple], backend) -> list:
        unique: dict[str, int] = {}
        for terms in payloads:
            for _c, pauli in terms:
                unique.setdefault(pauli, len(unique))
        with obs.span(
            "serve.handler", type=self.kind, batch=len(payloads),
            unique_terms=len(unique),
        ):
            vals = self.program().values(list(unique), backend)
        return [
            complex(sum(c * vals[unique[p]] for c, p in terms))
            for terms in payloads
        ]


class MarginalQueryHandler:
    """``kind="marginal"``: payload = a pattern with ``'*'`` wildcards
    → the marginal probability of its determined bits. The batching
    key carries the wildcard MASK — patterns sharing a mask share a
    structure and batch; distinct masks are distinct (cached)
    plans."""

    kind = "marginal"
    # one structure per mask, work linear in batch rows: batch-size
    # buckets see comparable seconds, so drift tracking is meaningful
    drift_stable = True
    # deterministic in the (string) pattern: safe to collapse
    # identical riders queue-level
    dedup_payloads = True

    def __init__(
        self,
        circuit: Circuit,
        pathfinder=None,
        plan_cache=None,
        target_size: float | None = None,
    ) -> None:
        self._circuit = circuit.copy()
        self.num_qubits = self._circuit.num_qubits()
        self.pathfinder = pathfinder
        self.plan_cache = plan_cache
        self.target_size = target_size
        self._bounds: dict[str, object] = {}

    def validate(self, payload) -> tuple[str, tuple]:
        bits = normalize_bitstring(payload, self.num_qubits)
        return bits, (self.kind, wildcard_mask(bits))

    def bound_for(self, mask: str):
        bound = self._bounds.get(mask)
        if bound is None:
            bound = bind_marginal(
                self._circuit.copy(),
                mask,
                self.pathfinder,
                self.plan_cache,
                self.target_size,
            )
            self._bounds[mask] = bound
        return bound

    def dispatch(self, payloads: Sequence[str], backend) -> list:
        with obs.span(
            "serve.handler", type=self.kind, batch=len(payloads),
        ):
            bound = self.bound_for(wildcard_mask(payloads[0]))
            probs = marginal_probabilities(bound, list(payloads), backend)
        return [float(p) for p in np.asarray(probs)]


def attach_query_handlers(
    service,
    circuit: Circuit,
    pathfinder=None,
    plan_cache=None,
    target_size: float | None = None,
) -> None:
    """Register sampling, expectation and marginal handlers for
    ``circuit`` on ``service`` (``circuit`` is copied, not consumed).
    ``plan_cache``/``target_size`` flow into every handler's planning,
    so all query structures share the service's cache and budget."""
    service.register_query_handler(
        SampleQueryHandler(
            ChainSampler(
                circuit,
                pathfinder=pathfinder,
                plan_cache=plan_cache,
                target_size=target_size,
            )
        )
    )
    service.register_query_handler(
        ExpectationQueryHandler(
            circuit, pathfinder, plan_cache, target_size
        )
    )
    service.register_query_handler(
        MarginalQueryHandler(circuit, pathfinder, plan_cache, target_size)
    )
