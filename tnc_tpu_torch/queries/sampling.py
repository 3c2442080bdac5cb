"""Bitstring sampling by qubit-by-qubit chain rule over marginal
networks (the port's counterpart of ``tnc_tpu.queries.sampling``).

Sampling b ~ |⟨b|C|0…0⟩|² factorizes as a chain of conditionals:
``p(b) = Π_k p(b_k | b_0..b_{k-1})``. Each conditional is ONE
contraction of a *marginal sandwich network* — circuit ++ adjoint
mirror with the already-sampled prefix qubits closed by bras (both
layers), qubit ``k`` left open (its 2×2 density block's diagonal is
the pair of unnormalized marginals ``p(prefix+'0')``/``p(prefix+'1')``)
and every later qubit traced against its mirror
(:meth:`~tnc_tpu_torch.builders.circuit_builder.Circuit.
into_sandwich_template`).

The structure of step ``k``'s network depends only on the PREFIX
LENGTH, never on the sampled bits — so each of the ``n`` structures
plans once (:func:`~tnc_tpu_torch.serve.rebind.bind_template`,
budget-sliced when needed) and every conditional is a bra rebind. All
in-flight samples' conditionals of a step go out as one batched
dispatch, after deduplicating identical prefixes — B
samples concentrate on few distinct prefixes early in the chain, so a
step usually dispatches far fewer than B conditionals.

Determinism: a seeded run is reproducible across processes (no
set-ordered iteration anywhere on the sampling path; prefix dedup uses
insertion-ordered dicts) — one uniform vector is drawn per qubit
position, sample-major, so a request's stream never depends on
co-riders batched with it. For the same seed and the same conditionals
the port draws the reference's bitstrings.

:data:`COUNTS` counts the chain steps walked (``steps``) and the
conditionals dispatched (``conditionals``).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from tnc_tpu_torch.builders.circuit_builder import Circuit

__all__ = ["ChainSampler", "sample_bitstrings"]

#: chain steps walked and conditionals dispatched, over every sampler
COUNTS: dict[str, int] = {"steps": 0, "conditionals": 0}


class ChainSampler:
    """Chain-rule bitstring sampler over one circuit.

    The constructor copies ``circuit`` (it stays usable); marginal
    structures bind lazily, one per prefix length. ``backend=None`` is
    ``TorchBackend()`` on the card, which raises without CUDA (the
    reference takes its complex128 ``NumpyBackend``); ``plan_cache`` and
    ``target_size`` flow into every prefix structure's planning.

    >>> from tnc_tpu_torch.ops.backends import NumpyBackend
    >>> from tnc_tpu_torch.tensornetwork.tensordata import TensorData
    >>> c = Circuit(); reg = c.allocate_register(2)
    >>> c.append_gate(TensorData.gate("x"), [reg.qubit(0)])
    >>> ChainSampler(c, backend=NumpyBackend()).sample(3, seed=0)
    ['10', '10', '10']
    """

    def __init__(
        self,
        circuit: Circuit,
        pathfinder=None,
        plan_cache=None,
        target_size: float | None = None,
        backend=None,
    ) -> None:
        self._circuit = circuit.copy()
        self.num_qubits = self._circuit.num_qubits()
        if self.num_qubits == 0:
            raise ValueError("cannot sample a 0-qubit circuit")
        self.pathfinder = pathfinder
        self.plan_cache = plan_cache
        self.target_size = target_size
        self.backend = backend
        self._bounds: dict[int, object] = {}  # prefix length -> BoundProgram

    # -- marginal structures ----------------------------------------------

    def bound_for(self, k: int):
        """The bound marginal program for prefix length ``k`` (planned
        and compiled on first use)."""
        bound = self._bounds.get(k)
        if bound is None:
            from tnc_tpu_torch.serve.rebind import bind_template

            spec = "?" * k + "o" + "*" * (self.num_qubits - k - 1)
            template = self._circuit.copy().into_sandwich_template(spec)
            bound = bind_template(
                template, self.pathfinder, self.plan_cache, self.target_size
            )
            self._bounds[k] = bound
        return bound

    def marginals(
        self, prefixes: Sequence[str], backend=None
    ) -> np.ndarray:
        """Unnormalized next-bit marginals for equal-length prefixes:
        ``out[i] = (p(prefixes[i] + '0'), p(prefixes[i] + '1'))`` with
        all later qubits traced out — one batched dispatch."""
        if not prefixes:
            return np.zeros((0, 2))
        k = len(prefixes[0])
        for p in prefixes:
            if len(p) != k:
                raise ValueError("all prefixes must have equal length")
        bound = self.bound_for(k)
        batch = [bound.template.request_bits(p) for p in prefixes]
        out = bound.amplitudes_det(batch, backend or self.backend)
        # the open qubit's two legs arrive in program result-leg order;
        # the diagonal is order-invariant (M and M^T share it)
        diag = np.einsum("bii->bi", out.reshape(len(prefixes), 2, 2))
        return np.real(diag)

    def conditionals(
        self, prefixes: Sequence[str], backend=None
    ) -> np.ndarray:
        """Normalized ``p(next bit = 0 | prefix), p(= 1 | prefix)`` rows
        for a batch of equal-length prefixes."""
        raw = self.marginals(prefixes, backend)
        totals = raw.sum(axis=1, keepdims=True)
        safe = np.where(totals > 0.0, totals, 1.0)
        out = raw / safe
        out[totals.reshape(-1) <= 0.0] = 0.5
        return out

    # -- sampling ----------------------------------------------------------

    def sample(
        self, n_samples: int, seed=None, backend=None
    ) -> list[str]:
        """``n_samples`` bitstrings from |⟨b|C|0⟩|², chain-rule order.
        ``seed`` feeds ``np.random.default_rng`` — a seeded run is
        deterministic across processes."""
        return self.sample_groups([(n_samples, seed)], backend)[0]

    def sample_groups(
        self,
        specs: Sequence[tuple[int, object]],
        backend=None,
    ) -> list[list[str]]:
        """Sample several independent requests ``(n_samples, seed)`` in
        one chain walk: every step dispatches the UNION of all in-flight
        samples' distinct prefixes as one batch, while each request
        draws from its own RNG in sample-major order — so a request's
        sampled stream is identical whether it rides alone or batched
        with co-riders (the dispatch-batching contract of the serving
        layer)."""
        sizes = []
        rngs = []
        for n_samples, seed in specs:
            n_samples = int(n_samples)
            if n_samples < 1:
                raise ValueError("n_samples must be >= 1")
            sizes.append(n_samples)
            rngs.append(np.random.default_rng(seed))
        total = sum(sizes)
        prefixes = [""] * total
        for _k in range(self.num_qubits):
            unique: dict[str, int] = {}
            for p in prefixes:
                unique.setdefault(p, len(unique))
            probs = self.conditionals(list(unique), backend)
            COUNTS["steps"] += 1
            COUNTS["conditionals"] += len(unique)
            draws = np.concatenate(
                [rng.random(n) for rng, n in zip(rngs, sizes)]
            )
            for i, prefix in enumerate(prefixes):
                p1 = probs[unique[prefix]][1]
                prefixes[i] = prefix + ("1" if draws[i] < p1 else "0")
        out: list[list[str]] = []
        start = 0
        for n_samples in sizes:
            out.append(prefixes[start : start + n_samples])
            start += n_samples
        return out


def sample_bitstrings(
    circuit: Circuit,
    n_samples: int,
    seed=None,
    pathfinder=None,
    plan_cache=None,
    target_size: float | None = None,
    backend=None,
) -> list[str]:
    """One-shot convenience over :class:`ChainSampler` (``circuit`` is
    copied, not consumed)."""
    return ChainSampler(
        circuit,
        pathfinder=pathfinder,
        plan_cache=plan_cache,
        target_size=target_size,
        backend=backend,
    ).sample(n_samples, seed=seed)
