"""Genetic-algorithm repartitioning (the port's copy of
``tnc_tpu.contractionpath.repartitioning.genetic``).

Mirror of ``tnc/src/contractionpath/repartitioning/genetic.rs``: evolve
partition-assignment chromosomes with single-gene mutation, uniform
crossover, and tournament selection (TNC uses the
``genetic_algorithm`` crate with population 100, stale limit 100,
``MutateSingleGene(0.2)``; this is a self-contained equivalent). Fitness
is evaluated by a process pool when cores are available, like the
TNC's ``.with_par_fitness(true)`` (``genetic.rs:103``); scoring is
a pure function of the chromosome so results are worker-count invariant.
"""

from __future__ import annotations

import logging
import os
import random
from dataclasses import dataclass
from typing import Sequence

from tnc_tpu_torch.contractionpath.communication_schemes import CommunicationScheme
from tnc_tpu_torch.contractionpath.repartitioning.simulated_annealing import (
    evaluate_partitioning,
)
from tnc_tpu_torch.resilience.retry import pool_map_with_retry
from tnc_tpu_torch.tensornetwork.tensor import CompositeTensor

logger = logging.getLogger(__name__)

_POOL_CTX = None


def _fitness_init(tensor, scheme, memory_limit):
    global _POOL_CTX
    _POOL_CTX = (tensor, scheme, memory_limit)


def _fitness_worker(args):
    seed, chromosome = args
    tensor, scheme, memory_limit = _POOL_CTX
    return evaluate_partitioning(
        tensor, chromosome, scheme, memory_limit, random.Random(seed)
    )


def _make_fitness_pool(tensor, scheme, memory_limit, population_size):
    import multiprocessing as mp

    from tnc_tpu_torch.contractionpath.repartitioning.simulated_annealing import (
        spawn_safe,
    )

    env = os.environ.get("TNC_TPU_SA_WORKERS")
    workers = (
        max(1, int(env))
        if env is not None
        else max(1, min(population_size, os.cpu_count() or 1))
    )
    if workers <= 1 or not spawn_safe():
        return None
    # the workers import this module and its host-only imports, never
    # torch: scoring is pure host math and cannot reach the card
    try:
        ctx = mp.get_context("spawn")
        return ctx.Pool(
            workers,
            initializer=_fitness_init,
            initargs=(tensor, scheme, memory_limit),
        )
    except Exception:
        return None


@dataclass
class GeneticSettings:
    population_size: int = 100
    mutation_probability: float = 0.2
    tournament_size: int = 4
    stale_limit: int = 100
    max_generations: int = 1000


def balance_partitions(
    tensor: CompositeTensor,
    initial_partitioning: Sequence[int],
    num_partitions: int,
    rng: random.Random,
    communication_scheme: CommunicationScheme = CommunicationScheme.GREEDY,
    memory_limit: float | None = None,
    settings: GeneticSettings | None = None,
    max_time: float | None = None,
) -> tuple[list[int], float]:
    """Evolve the partitioning; returns (best chromosome, best score).

    >>> import random
    >>> from tnc_tpu_torch.tensornetwork.tensor import CompositeTensor, LeafTensor
    >>> tn = CompositeTensor([LeafTensor([0, 1], [2, 2]),
    ...     LeafTensor([1, 2], [2, 2]), LeafTensor([2, 3], [2, 2]),
    ...     LeafTensor([3, 0], [2, 2])])
    >>> best, score = balance_partitions(
    ...     tn, [0, 0, 1, 1], 2, random.Random(0),
    ...     settings=GeneticSettings(population_size=4, max_generations=2))
    >>> len(best), score > 0
    (4, True)
    """
    import time

    settings = settings or GeneticSettings()
    deadline = time.monotonic() + max_time if max_time else None
    pool = _make_fitness_pool(
        tensor, communication_scheme, memory_limit, settings.population_size
    )

    def score_population(population: list[list[int]]) -> list[tuple[float, list[int]]]:
        nonlocal pool
        jobs = [(rng.getrandbits(64), c) for c in population]
        # transient pool failures (a worker lost to a timeout/preemption)
        # get ONE retry on a FRESH pool; anything else logs the real
        # worker error and falls back to serial evaluation (identical
        # results, slower) — see resilience.retry.pool_map_with_retry
        scores, pool = pool_map_with_retry(
            pool,
            lambda p: p.map_async(_fitness_worker, jobs).get(timeout=600.0),
            lambda: _make_fitness_pool(
                tensor, communication_scheme, memory_limit,
                settings.population_size,
            ),
            logger,
            "genetic fitness pool",
        )
        if scores is not None:
            return list(zip(scores, population))
        return [
            (
                evaluate_partitioning(
                    tensor,
                    c,
                    communication_scheme,
                    memory_limit,
                    random.Random(seed),
                ),
                c,
            )
            for seed, c in jobs
        ]

    def mutate(chromosome: list[int]) -> list[int]:
        out = list(chromosome)
        if rng.random() < settings.mutation_probability:
            gene = rng.randrange(len(out))
            out[gene] = rng.randrange(num_partitions)
        return out

    def crossover(a: list[int], b: list[int]) -> list[int]:
        return [x if rng.random() < 0.5 else y for x, y in zip(a, b)]

    def tournament(scored: list[tuple[float, list[int]]]) -> list[int]:
        picks = [scored[rng.randrange(len(scored))] for _ in range(settings.tournament_size)]
        return min(picks, key=lambda p: p[0])[1]

    population = [list(initial_partitioning)]
    for _ in range(settings.population_size - 1):
        population.append(mutate(list(initial_partitioning)))

    try:
        scored = score_population(population)
        best_score, best = min(scored, key=lambda p: p[0])
        stale = 0

        for _generation in range(settings.max_generations):
            if stale >= settings.stale_limit:
                break
            if deadline is not None and time.monotonic() > deadline:
                break
            next_population = [best]  # elitism
            while len(next_population) < settings.population_size:
                child = mutate(crossover(tournament(scored), tournament(scored)))
                next_population.append(child)
            population = next_population
            scored = score_population(population)
            gen_best_score, gen_best = min(scored, key=lambda p: p[0])
            if gen_best_score < best_score:
                best_score, best = gen_best_score, gen_best
                stale = 0
            else:
                stale += 1
    finally:
        if pool is not None:
            pool.terminate()
            pool.join()

    return best, best_score
