"""Optimization methods for the sweep phase (the port's copy of
``tnc_tpu.benchmark.methods``).

Generic (plain partition + greedy), the SA repartitioning models, the
genetic search, greedy tree balancing, and the tree-refinement finders,
on the port's planners. Every method maps a flat network to a
(partitioned network, nested path) pair under a time budget; the
partitioning methods give nested paths, the tree finders flat ones.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Callable

from tnc_tpu_torch.contractionpath.balancing import (
    BalanceSettings,
    balance_partitions_iter,
)
from tnc_tpu_torch.contractionpath.communication_schemes import CommunicationScheme
from tnc_tpu_torch.contractionpath.contraction_path import ContractionPath
from tnc_tpu_torch.contractionpath.paths import TreeAnnealing, TreeTempering
from tnc_tpu_torch.contractionpath.paths.hyper import Hyperoptimizer
from tnc_tpu_torch.contractionpath.repartitioning import compute_solution
from tnc_tpu_torch.contractionpath.repartitioning.genetic import (
    balance_partitions as genetic_balance,
)
from tnc_tpu_torch.contractionpath.repartitioning.simulated_annealing import (
    IntermediatePartitioningModel,
    LeafPartitioningModel,
    NaiveIntermediatePartitioningModel,
    NaivePartitioningModel,
    balance_partitions,
)
from tnc_tpu_torch.tensornetwork.partitioning import find_partitioning
from tnc_tpu_torch.tensornetwork.tensor import CompositeTensor


@dataclass
class MethodRun:
    """A named sweep method."""

    name: str
    run: Callable[
        ["MethodContext"], tuple[CompositeTensor, ContractionPath]
    ]


@dataclass
class MethodContext:
    tn: CompositeTensor  # flat network
    partitions: int
    seed: int
    time_budget: float  # seconds (the CLI's default: 10 min)
    communication_scheme: CommunicationScheme = CommunicationScheme.GREEDY

    @property
    def rng(self) -> random.Random:
        return random.Random(self.seed)

    def initial_partitioning(self) -> list[int]:
        return find_partitioning(self.tn, self.partitions, seed=self.seed)


def _solution_for(
    ctx: MethodContext, partitioning: list[int]
) -> tuple[CompositeTensor, ContractionPath]:
    partitioned, path, _, _ = compute_solution(
        ctx.tn, partitioning, ctx.communication_scheme, ctx.rng
    )
    return partitioned, path


def _generic(ctx: MethodContext):
    """Partition + greedy local paths, no refinement (``Generic``)."""
    return _solution_for(ctx, ctx.initial_partitioning())


def _sa(model_cls):
    def run(ctx: MethodContext):
        needs_k = model_cls in (
            NaivePartitioningModel,
            NaiveIntermediatePartitioningModel,
        )
        if needs_k:
            model = model_cls(
                ctx.tn, ctx.partitions, ctx.communication_scheme
            )
        else:
            model = model_cls(ctx.tn, ctx.communication_scheme)
        initial = model.initial_solution(ctx.initial_partitioning())
        best, _ = balance_partitions(
            model, initial, ctx.rng, max_time=ctx.time_budget
        )
        partitioning = best if isinstance(best, list) else list(best[0])
        return _solution_for(ctx, partitioning)

    return run


def _genetic(ctx: MethodContext):
    best, _ = genetic_balance(
        ctx.tn,
        ctx.initial_partitioning(),
        ctx.partitions,
        ctx.rng,
        ctx.communication_scheme,
        max_time=ctx.time_budget,
    )
    return _solution_for(ctx, list(best))


def _greedy_balance(ctx: MethodContext):
    settings = BalanceSettings(communication_scheme=ctx.communication_scheme)
    _, tn, path, _ = balance_partitions_iter(
        ctx.tn, ctx.initial_partitioning(), settings, ctx.rng
    )
    return tn, path


def _flat_finder(make_finder):
    """Methods that skip partitioning: one flat refined path."""

    def run(ctx: MethodContext):
        finder = make_finder(ctx)
        result = finder.find_path(ctx.tn)
        return ctx.tn, result.replace_path()

    return run


def methods_example():
    """The sweep-method registry: the reference's ten methods.

    >>> sorted(METHODS)[:4]
    ['genetic', 'greedy', 'greedy-balance', 'hyper']
    >>> import numpy as np
    >>> from tnc_tpu_torch.builders.connectivity import ConnectivityLayout
    >>> from tnc_tpu_torch.builders.random_circuit import random_circuit
    >>> tn = random_circuit(6, 4, 0.5, 0.5, np.random.default_rng(0),
    ...                     ConnectivityLayout.LINE)
    >>> ctx = MethodContext(tn, partitions=2, seed=1, time_budget=2.0)
    >>> ptn, path = METHODS["greedy"].run(ctx)
    >>> len(ptn) >= 1 and path.toplevel is not None
    True
    """


METHODS: dict[str, MethodRun] = {
    m.name: m
    for m in [
        MethodRun("greedy", _generic),
        MethodRun("sa-naive", _sa(NaivePartitioningModel)),
        MethodRun("sa-naive-intermediate", _sa(NaiveIntermediatePartitioningModel)),
        MethodRun("sa-leaf", _sa(LeafPartitioningModel)),
        MethodRun("sa-intermediate", _sa(IntermediatePartitioningModel)),
        MethodRun("genetic", _genetic),
        MethodRun("greedy-balance", _greedy_balance),
        MethodRun(
            "tree-anneal",
            _flat_finder(lambda ctx: TreeAnnealing(seed=ctx.seed)),
        ),
        MethodRun(
            "tree-temper",
            _flat_finder(lambda ctx: TreeTempering(seed=ctx.seed)),
        ),
        MethodRun(
            "hyper",
            _flat_finder(lambda ctx: Hyperoptimizer(seed=ctx.seed)),
        ),
    ]
}
