"""Simulated-annealing repartitioning (the port's copy of
``tnc_tpu.contractionpath.repartitioning.simulated_annealing``: the same
assignment and score for the same ``random.Random`` seed).

Mirror of ``tnc/src/contractionpath/repartitioning/simulated_annealing.rs``:
an SA engine with a wall-clock budget, log-interpolated temperature
(2.0 → 0.05), restart-after-stale, multi-chain trial generation, and
acceptance probability ``exp(-log2(score/current) / T)``
(``simulated_annealing.rs:122-127``), plus four move models:

- :class:`NaivePartitioningModel` — random tensor → random partition.
- :class:`NaiveIntermediatePartitioningModel` — random *subtree* of a
  partition's local path → random partition.
- :class:`LeafPartitioningModel` — random tensor → the partition whose
  external tensor shrinks the most.
- :class:`IntermediatePartitioningModel` — random subtree → best
  partition (TNC's book calls this the best method).

Scores are the critical-path (parallel) cost from
:func:`~tnc_tpu_torch.contractionpath.repartitioning.compute_solution`;
exceeding a memory limit scores infinity
(``simulated_annealing.rs:171-199``).

Parallel search: like TNC's fixed 48 rayon chains
(``PROCESSING_THREADS = 48``, ``simulated_annealing.rs:33-35,113-135``),
chains are pure functions of (model, seed, start state, temperature) and
can be evaluated concurrently by a process pool — results are identical
whether chains run inline or pooled, so seeded determinism is preserved
at any worker count. Workers default to the host's CPU count
(``TNC_TPU_SA_WORKERS`` overrides).

Evaluation is incremental: models that carry per-partition local paths
score trials with :func:`compute_solution_with_paths`, skipping the
all-partitions Greedy re-run (TNC re-paths only the two
touched partitions per move, ``simulated_annealing.rs:457-562``).
"""

from __future__ import annotations

import logging
import math
import os
import random
import time
from dataclasses import dataclass
from typing import Sequence

logger = logging.getLogger(__name__)

from tnc_tpu_torch.contractionpath.communication_schemes import CommunicationScheme
from tnc_tpu_torch.contractionpath.contraction_cost import (
    communication_path_op_costs,
    compute_memory_requirements,
    contract_path_cost,
    contract_size_tensors_bytes,
)
from tnc_tpu_torch.contractionpath.contraction_path import ContractionPath
from tnc_tpu_torch.contractionpath.paths.greedy import Greedy, OptMethod
from tnc_tpu_torch.contractionpath.repartitioning import (
    compute_solution,
    compute_solution_with_paths,
)
from tnc_tpu_torch.resilience.retry import pool_map_with_retry
from tnc_tpu_torch.tensornetwork.tensor import CompositeTensor, LeafTensor


def evaluate_partitioning(
    tensor: CompositeTensor,
    partitioning: Sequence[int],
    communication_scheme: CommunicationScheme,
    memory_limit: float | None,
    rng: random.Random,
) -> float:
    partitioned, path, parallel_cost, _ = compute_solution(
        tensor, partitioning, communication_scheme, rng
    )
    if memory_limit is not None:
        mem = compute_memory_requirements(
            partitioned.tensors, path, contract_size_tensors_bytes
        )
        if mem > memory_limit:
            return math.inf
    return parallel_cost


def evaluate_partitioning_with_paths(
    tensor: CompositeTensor,
    partitioning: Sequence[int],
    local_paths: Sequence[Sequence[tuple[int, int]]],
    communication_scheme: CommunicationScheme,
    memory_limit: float | None,
    rng: random.Random,
) -> float:
    """Incremental score: reuse the solution's per-partition paths."""
    partitioned, path, parallel_cost, _ = compute_solution_with_paths(
        tensor, partitioning, local_paths, communication_scheme, rng
    )
    if memory_limit is not None:
        mem = compute_memory_requirements(
            partitioned.tensors, path, contract_size_tensors_bytes
        )
        if mem > memory_limit:
            return math.inf
    return parallel_cost


def _evaluate_cached(
    tensor: CompositeTensor,
    partitioning: Sequence[int],
    local_paths: Sequence[Sequence[tuple[int, int]]],
    externals: Sequence[LeafTensor],
    local_costs: Sequence[float],
    communication_scheme: CommunicationScheme,
    memory_limit: float | None,
    rng: random.Random,
) -> float:
    """Score a solution from its per-block caches: only the fan-in
    schedule is recomputed (the per-block paths, externals, and local
    costs were maintained by the move that produced the solution). This
    is the hot function of the SA loop."""
    if memory_limit is not None:
        # memory accounting needs the full path; take the slower route
        return evaluate_partitioning_with_paths(
            tensor,
            partitioning,
            local_paths,
            communication_scheme,
            memory_limit,
            rng,
        )
    present_set = set(partitioning)
    present = sorted(present_set)
    children_tensors = [externals[b] for b in present]
    latency_map = {i: local_costs[b] for i, b in enumerate(present)}
    communication_path = communication_scheme.communication_path(
        children_tensors, latency_map, rng
    )
    tensor_costs = [latency_map[i] for i in range(len(children_tensors))]
    (parallel_cost, _), _ = communication_path_op_costs(
        children_tensors, communication_path, True, tensor_costs
    )
    return parallel_cost


class OptModel:
    """Trial-generation + scoring interface (``simulated_annealing.rs:38-51``)."""

    def generate_trial_solution(self, current, rng: random.Random):
        raise NotImplementedError

    def evaluate(self, solution, rng: random.Random) -> float:
        raise NotImplementedError

    def _require_multiple_partitions(self) -> None:
        # A 1-partition model has no moves: the trial loops that pick a
        # different target partition would spin forever.
        if self.num_partitions < 2:
            raise ValueError(
                f"{type(self).__name__} needs num_partitions >= 2, "
                f"got {self.num_partitions}"
            )


@dataclass
class NaivePartitioningModel(OptModel):
    """Move-one-leaf trial model scored by naive serial cost.

    >>> import random
    >>> from tnc_tpu_torch.tensornetwork.tensor import CompositeTensor, LeafTensor
    >>> tn = CompositeTensor([LeafTensor([0, 1], [2, 2]),
    ...     LeafTensor([1, 2], [2, 2]), LeafTensor([2, 3], [2, 2]),
    ...     LeafTensor([3, 0], [2, 2])])
    >>> model = NaivePartitioningModel(tn, 2)
    >>> best, score = balance_partitions(
    ...     model, model.initial_solution([0, 0, 1, 1]),
    ...     random.Random(0), max_time=0.5, n_trials=4, n_workers=0)
    >>> len(best), score > 0
    (4, True)
    """

    tensor: CompositeTensor
    num_partitions: int
    communication_scheme: CommunicationScheme = CommunicationScheme.GREEDY
    memory_limit: float | None = None

    def __post_init__(self) -> None:
        self._require_multiple_partitions()

    def initial_solution(self, partitioning: Sequence[int]) -> list[int]:
        return list(partitioning)

    def generate_trial_solution(self, current: list[int], rng: random.Random):
        solution = list(current)
        index = rng.randrange(len(solution))
        current_partition = solution[index]
        while True:
            b = rng.randrange(self.num_partitions)
            if b != current_partition:
                break
        solution[index] = b
        return solution

    def evaluate(self, solution: list[int], rng: random.Random) -> float:
        return evaluate_partitioning(
            self.tensor, solution, self.communication_scheme, self.memory_limit, rng
        )


def _local_greedy_path(tensors: list) -> list[tuple[int, int]]:
    tn = CompositeTensor(tensors)
    if len(tn) <= 1:
        return []
    return Greedy(OptMethod.GREEDY).find_path(tn).replace_path().toplevel


def _blocks_by_id(
    tensor: CompositeTensor,
    partitioning: Sequence[int],
    num_partitions: int | None = None,
) -> list[list]:
    """Tensors grouped by partition *id* (possibly-empty blocks kept, so
    per-id caches stay aligned with the ids moves use)."""
    k = num_partitions if num_partitions is not None else max(partitioning) + 1
    blocks: list[list] = [[] for _ in range(k)]
    for t, b in zip(tensor.tensors, partitioning):
        blocks[b].append(t)
    return blocks


def _external_of(tensors: list) -> LeafTensor:
    out = LeafTensor()
    for t in tensors:
        out = out ^ t
    return out


def _subtree_leaves(
    local_path: list[tuple[int, int]], pair_index: int
) -> set[int]:
    """Leaves contributing to the contraction at ``pair_index``
    (``simulated_annealing.rs:279-292``): walk earlier pairs backwards,
    collecting partners of already-included results."""
    i, j = local_path[pair_index]
    leaves = {i, j}
    for a, b in reversed(local_path[:pair_index]):
        if a in leaves:
            leaves.add(b)
    return leaves


def _pick_subtree_and_indices(
    partitioning: list[int],
    local_paths: list[list[tuple[int, int]]],
    rng: random.Random,
) -> tuple[int, list[int]] | None:
    """Pick a source partition with >=3 local pairs and a random subtree;
    return (source partition, global tensor indices to move)."""
    viable = [p for p, path in enumerate(local_paths) if len(path) >= 3]
    if not viable:
        return None
    source = rng.choice(viable)
    pair_index = rng.randrange(len(local_paths[source]) - 1)
    leaves = _subtree_leaves(local_paths[source], pair_index)

    shifted_global: list[int] = []
    local_index = 0
    for global_index, partition in enumerate(partitioning):
        if partition != source:
            continue
        if local_index in leaves:
            shifted_global.append(global_index)
        local_index += 1
    return source, shifted_global


def _local_path_cost(tensors: list, path: list[tuple[int, int]]) -> float:
    if len(tensors) <= 1 or not path:
        return 0.0
    cost, _ = contract_path_cost(tensors, ContractionPath.simple(path), True)
    return cost


def _recompute_two_paths(
    tensor: CompositeTensor,
    partitioning: list[int],
    local_paths: list[list[tuple[int, int]]],
    source: int,
    target: int,
    local_costs: list[float] | None = None,
) -> None:
    """Re-path (and re-cost) only the two partitions a move touched
    (``simulated_annealing.rs:457-562``)."""
    from_tensors = []
    to_tensors = []
    for partition, t in zip(partitioning, tensor.tensors):
        if partition == source:
            from_tensors.append(t)
        elif partition == target:
            to_tensors.append(t)
    local_paths[source] = _local_greedy_path(from_tensors)
    local_paths[target] = _local_greedy_path(to_tensors)
    if local_costs is not None:
        local_costs[source] = _local_path_cost(from_tensors, local_paths[source])
        local_costs[target] = _local_path_cost(to_tensors, local_paths[target])


@dataclass
class NaiveIntermediatePartitioningModel(OptModel):
    """Moves a random subtree to a random partition.

    Solution: (partitioning, local_paths, externals, local_costs) — the
    last two are per-block caches so :func:`_evaluate_cached` only has to
    redo the fan-in schedule.
    """

    tensor: CompositeTensor
    num_partitions: int
    communication_scheme: CommunicationScheme = CommunicationScheme.GREEDY
    memory_limit: float | None = None

    def __post_init__(self) -> None:
        self._require_multiple_partitions()

    def initial_solution(self, partitioning: Sequence[int]):
        blocks = _blocks_by_id(self.tensor, partitioning, self.num_partitions)
        paths = [_local_greedy_path(block) for block in blocks]
        externals = [_external_of(block) for block in blocks]
        costs = [_local_path_cost(b, p) for b, p in zip(blocks, paths)]
        return list(partitioning), paths, externals, costs

    def generate_trial_solution(self, current, rng: random.Random):
        partitioning, local_paths, externals, local_costs = current
        partitioning = list(partitioning)
        local_paths = [list(p) for p in local_paths]
        externals = list(externals)
        local_costs = list(local_costs)

        picked = _pick_subtree_and_indices(partitioning, local_paths, rng)
        if picked is None:
            return partitioning, local_paths, externals, local_costs
        source, shifted = picked
        while True:
            target = rng.randrange(self.num_partitions)
            if target != source:
                break
        shifted_external = LeafTensor()
        for index in shifted:
            partitioning[index] = target
            shifted_external = shifted_external ^ self.tensor.tensors[index]
        externals[source] = externals[source] ^ shifted_external
        externals[target] = externals[target] ^ shifted_external
        _recompute_two_paths(
            self.tensor, partitioning, local_paths, source, target, local_costs
        )
        return partitioning, local_paths, externals, local_costs

    def evaluate(self, solution, rng: random.Random) -> float:
        return _evaluate_cached(
            self.tensor,
            solution[0],
            solution[1],
            solution[2],
            solution[3],
            self.communication_scheme,
            self.memory_limit,
            rng,
        )


@dataclass
class LeafPartitioningModel(OptModel):
    """Moves a random tensor to the partition maximizing size reduction."""

    tensor: CompositeTensor
    communication_scheme: CommunicationScheme = CommunicationScheme.GREEDY
    memory_limit: float | None = None

    def initial_solution(
        self, partitioning: Sequence[int]
    ) -> tuple[list[int], list[LeafTensor]]:
        blocks = _blocks_by_id(self.tensor, partitioning)
        externals = [_external_of(block) for block in blocks]
        return list(partitioning), externals

    def generate_trial_solution(self, current, rng: random.Random):
        partitioning, partition_tensors = current
        partitioning = list(partitioning)
        partition_tensors = [t.copy() for t in partition_tensors]

        index = rng.randrange(len(partitioning))
        shifted = self.tensor.tensors[index]
        source = partitioning[index]

        best_target = -1
        best_score = math.inf
        for p, external in enumerate(partition_tensors):
            if p == source:
                continue
            score = (shifted ^ external).size() - external.size()
            if score < best_score:
                best_score = score
                best_target = p
        if best_target < 0:
            return partitioning, partition_tensors

        partitioning[index] = best_target
        partition_tensors[source] = partition_tensors[source] ^ shifted
        partition_tensors[best_target] = partition_tensors[best_target] ^ shifted
        return partitioning, partition_tensors

    def evaluate(self, solution, rng: random.Random) -> float:
        return evaluate_partitioning(
            self.tensor, solution[0], self.communication_scheme, self.memory_limit, rng
        )


@dataclass
class IntermediatePartitioningModel(OptModel):
    """Moves a random subtree to the partition maximizing size reduction
    (TNC's best-performing model, ``book/src/partitioning.md``)."""

    tensor: CompositeTensor
    communication_scheme: CommunicationScheme = CommunicationScheme.GREEDY
    memory_limit: float | None = None

    def initial_solution(
        self,
        partitioning: Sequence[int],
        initial_paths: list[list[tuple[int, int]]] | None = None,
    ):
        blocks = _blocks_by_id(self.tensor, partitioning)
        externals = [_external_of(block) for block in blocks]
        paths = initial_paths or [_local_greedy_path(block) for block in blocks]
        costs = [_local_path_cost(b, p) for b, p in zip(blocks, paths)]
        return list(partitioning), externals, paths, costs

    def generate_trial_solution(self, current, rng: random.Random):
        partitioning, partition_tensors, local_paths, local_costs = current
        partitioning = list(partitioning)
        partition_tensors = [t.copy() for t in partition_tensors]
        local_paths = [list(p) for p in local_paths]
        local_costs = list(local_costs)

        picked = _pick_subtree_and_indices(partitioning, local_paths, rng)
        if picked is None:
            return partitioning, partition_tensors, local_paths, local_costs
        source, shifted_indices = picked

        shifted = LeafTensor()
        for index in shifted_indices:
            shifted = shifted ^ self.tensor.tensors[index]

        best_target = -1
        best_score = math.inf
        for p, external in enumerate(partition_tensors):
            if p == source:
                continue
            score = (shifted ^ external).size() - external.size()
            if score < best_score:
                best_score = score
                best_target = p
        if best_target < 0:
            return partitioning, partition_tensors, local_paths, local_costs

        for index in shifted_indices:
            partitioning[index] = best_target
        partition_tensors[source] = partition_tensors[source] ^ shifted
        partition_tensors[best_target] = partition_tensors[best_target] ^ shifted
        _recompute_two_paths(
            self.tensor, partitioning, local_paths, source, best_target, local_costs
        )
        return partitioning, partition_tensors, local_paths, local_costs

    def evaluate(self, solution, rng: random.Random) -> float:
        return _evaluate_cached(
            self.tensor,
            solution[0],
            solution[2],
            solution[1],
            solution[3],
            self.communication_scheme,
            self.memory_limit,
            rng,
        )


def _run_chain(model, seed, steps, temperature, solution, score):
    """One SA chain: pure function of its arguments — identical results
    inline or in a worker process (TNC's reproducibility
    rationale for a fixed chain count, ``simulated_annealing.rs:33-35``)."""
    chain_rng = random.Random(seed)
    trial_solution, trial_score = solution, score
    for _ in range(steps):
        candidate = model.generate_trial_solution(trial_solution, chain_rng)
        candidate_score = model.evaluate(candidate, chain_rng)
        if candidate_score <= 0 or trial_score <= 0:
            accept = candidate_score < trial_score
        else:
            diff = math.log2(candidate_score / trial_score)
            accept = math.exp(-diff / temperature) >= chain_rng.random()
        if accept:
            trial_solution = candidate
            trial_score = candidate_score
    return trial_score, trial_solution


_POOL_MODEL: OptModel | None = None


def _pool_init(model: OptModel) -> None:
    global _POOL_MODEL
    _POOL_MODEL = model


def _pool_chain(args):
    seed, steps, temperature, solution, score = args
    return _run_chain(_POOL_MODEL, seed, steps, temperature, solution, score)


def spawn_safe() -> bool:
    """Whether a spawn-context pool can work here: spawn re-imports the
    parent's ``__main__``, which crash-loops when that module has no
    importable file (stdin scripts, embedded interpreters)."""
    import __main__

    main_file = getattr(__main__, "__file__", None)
    if main_file is None:
        return True  # interactive/pytest-style __main__: spawn handles it
    return os.path.exists(main_file)


@dataclass
class SimulatedAnnealingOptimizer:
    """SA engine (``simulated_annealing.rs:54-167``).

    ``n_workers``: process count for chain evaluation (None = min of
    ``n_trials`` and the CPU count; ``TNC_TPU_SA_WORKERS`` overrides).
    Workers import this module and its host-only imports, never torch,
    so they cannot touch the card; scoring is pure host math.
    """

    n_trials: int = 8
    max_time: float = 10.0
    n_steps: int = 80
    restart_iter: int = 50
    initial_temperature: float = 2.0
    final_temperature: float = 0.05
    n_workers: int | None = None
    # Work-bounded mode: run exactly this many rounds with a round-indexed
    # temperature schedule — fully deterministic at any worker count
    # (wall-clock budgets make round counts machine-dependent).
    max_rounds: int | None = None

    def _resolve_workers(self) -> int:
        env = os.environ.get("TNC_TPU_SA_WORKERS")
        if env is not None:
            return max(1, int(env))
        if self.n_workers is not None:
            return max(1, self.n_workers)
        return max(1, min(self.n_trials, os.cpu_count() or 1))

    def _make_pool(self, model: OptModel):
        import multiprocessing as mp

        workers = self._resolve_workers()
        if workers <= 1 or not spawn_safe():
            return None
        try:
            ctx = mp.get_context("spawn")
            return ctx.Pool(workers, initializer=_pool_init, initargs=(model,))
        except Exception:
            return None

    def optimize(self, model: OptModel, initial_solution, rng: random.Random):
        current_score = model.evaluate(initial_solution, rng)
        current_solution = initial_solution
        best_solution = current_solution
        best_score = current_score
        last_improvement = 0
        steps_per_chain = -(-self.n_steps // self.n_trials)

        log_start = math.log2(self.initial_temperature)
        log_end = math.log2(self.final_temperature)
        temperature = self.initial_temperature
        start = time.monotonic()
        end_time = start + self.max_time
        pool = self._make_pool(model)
        pool_timeout = max(300.0, 10.0 * self.max_time)
        rounds = 0

        try:
            while True:
                # Fresh per-round, per-chain seeds from the master rng:
                # chain results depend only on (seed, state, temperature),
                # never on worker scheduling.
                jobs = [
                    (
                        rng.getrandbits(64),
                        steps_per_chain,
                        temperature,
                        current_solution,
                        current_score,
                    )
                    for _ in range(self.n_trials)
                ]
                # transient pool failures get ONE retry on a FRESH pool;
                # other failures log the real worker error with the
                # decision and fall back to serial chains for the rest
                # of the run — see resilience.retry.pool_map_with_retry
                results, pool = pool_map_with_retry(
                    pool,
                    lambda p: p.map_async(_pool_chain, jobs).get(
                        timeout=pool_timeout
                    ),
                    lambda: self._make_pool(model),
                    logger,
                    "simulated-annealing chain pool",
                )
                if results is None:
                    results = [_run_chain(model, *job) for job in jobs]

                best_chain = None
                for trial_score, trial_solution in results:
                    if best_chain is None or trial_score < best_chain[0]:
                        best_chain = (trial_score, trial_solution)
                assert best_chain is not None
                current_score, current_solution = best_chain

                if current_score < best_score:
                    best_solution = current_solution
                    best_score = current_score
                    last_improvement = 0
                last_improvement += 1
                if last_improvement == self.restart_iter:
                    current_solution = best_solution
                    current_score = best_score

                rounds += 1
                if self.max_rounds is not None:
                    if rounds >= self.max_rounds:
                        break
                    progress = rounds / self.max_rounds
                else:
                    now = time.monotonic()
                    if now > end_time:
                        break
                    progress = 1.0 - (end_time - now) / self.max_time
                temperature = 2.0 ** (log_start + (log_end - log_start) * progress)
        finally:
            if pool is not None:
                pool.terminate()
                pool.join()

        return best_solution, best_score


def balance_partitions(
    model: OptModel,
    initial_solution,
    rng: random.Random,
    max_time: float = 10.0,
    n_trials: int = 48,
    n_workers: int | None = None,
    max_rounds: int | None = None,
):
    """Run SA with TNC's engine settings: 48 chains x 10 steps
    per round (``simulated_annealing.rs:33-35,576-595``). Pass
    ``max_rounds`` for a work-bounded, machine-independent run."""
    optimizer = SimulatedAnnealingOptimizer(
        n_trials=n_trials,
        max_time=max_time,
        n_steps=n_trials * 10,
        restart_iter=50,
        initial_temperature=2.0,
        final_temperature=0.05,
        n_workers=n_workers,
        max_rounds=max_rounds,
    )
    return optimizer.optimize(model, initial_solution, rng)
