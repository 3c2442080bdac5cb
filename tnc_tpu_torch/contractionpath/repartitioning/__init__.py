"""Partitioning refinement: evaluate and improve a partition assignment
(the port's copy of ``tnc_tpu.contractionpath.repartitioning``).

Mirror of ``tnc/src/contractionpath/repartitioning.rs``:
:func:`compute_solution` is the shared evaluation kernel — partition the
network, find greedy local paths per partition, schedule the fan-in with a
communication scheme using the local costs as latencies, and return the
critical-path (parallel) and sum (serial) costs.
"""

from __future__ import annotations

import random
from typing import Sequence

from tnc_tpu_torch.contractionpath.communication_schemes import CommunicationScheme
from tnc_tpu_torch.contractionpath.contraction_cost import (
    communication_path_op_costs,
    contract_path_cost,
)
from tnc_tpu_torch.contractionpath.contraction_path import ContractionPath
from tnc_tpu_torch.contractionpath.paths.greedy import Greedy, OptMethod
from tnc_tpu_torch.tensornetwork.partitioning import partition_tensor_network
from tnc_tpu_torch.tensornetwork.tensor import CompositeTensor


def _fanin_cost_function(cost_model):
    """Per-pair fan-in cost in the latency domain: predicted seconds
    under a calibrated model, naive op counts otherwise (None selects
    the default inside :func:`communication_path_op_costs`)."""
    if cost_model is None:
        return None
    from tnc_tpu_torch.contractionpath.contraction_cost import CalibratedObjective

    return CalibratedObjective(cost_model).pair_cost


def compute_solution(
    tensor: CompositeTensor,
    partitioning: Sequence[int],
    communication_scheme: CommunicationScheme = CommunicationScheme.GREEDY,
    rng: random.Random | None = None,
    cost_model=None,
) -> tuple[CompositeTensor, ContractionPath, float, float]:
    """(partitioned network, full path, parallel cost, serial cost)
    for a partition assignment (``repartitioning.rs:25-76``).

    ``cost_model`` (a :class:`~tnc_tpu_torch.obs.calibrate.
    CalibratedCostModel`) moves the whole evaluation into the seconds
    domain: per-partition latencies become predicted local completion
    times (dispatch overhead charged per local step), the scheme
    schedules against them, and the returned parallel/serial costs are
    predicted seconds instead of op counts."""
    partitioned = partition_tensor_network(
        CompositeTensor(list(tensor.tensors)), partitioning
    )

    result = Greedy(OptMethod.GREEDY).find_path(partitioned)
    path = result.replace_path()

    latency_map = {i: 0.0 for i in range(len(partitioned))}
    local_steps = {i: 0.0 for i in range(len(partitioned))}
    for i, local_path in path.nested.items():
        child = partitioned[i]
        local_cost, _ = contract_path_cost(child.tensors, local_path, True)
        latency_map[i] = local_cost
        local_steps[i] = float(len(local_path.toplevel))
    if cost_model is not None:
        from tnc_tpu_torch.contractionpath.communication_schemes import (
            calibrated_latency_map,
        )

        latency_map = calibrated_latency_map(
            latency_map, cost_model, local_steps
        )

    children_tensors = [child.external_tensor() for child in partitioned]
    communication_path = communication_scheme.communication_path(
        children_tensors, latency_map, rng, cost_model=cost_model
    )
    tensor_costs = [latency_map[i] for i in range(len(children_tensors))]
    (parallel_cost, sum_cost), _ = communication_path_op_costs(
        children_tensors, communication_path, True, tensor_costs,
        cost_function=_fanin_cost_function(cost_model),
    )

    final_path = ContractionPath(path.nested, communication_path)
    return partitioned, final_path, parallel_cost, sum_cost


def compute_solution_with_paths(
    tensor: CompositeTensor,
    partitioning: Sequence[int],
    local_paths: Sequence[Sequence[tuple[int, int]]],
    communication_scheme: CommunicationScheme = CommunicationScheme.GREEDY,
    rng: random.Random | None = None,
    communication_path: Sequence[tuple[int, int]] | None = None,
    cost_model=None,
) -> tuple[CompositeTensor, ContractionPath, float, float]:
    """Like :func:`compute_solution`, but reuses caller-maintained local
    paths instead of re-running Greedy on every partition.

    This is the incremental evaluation kernel for the SA models
    (mirroring ``simulated_annealing.rs:457-562``, where a trial move
    re-paths only the two touched partitions): ``local_paths[b]`` is the
    replace-path over block ``b``'s tensors in original order. Empty
    blocks are dropped and blocks ordered by id, exactly as
    :func:`~tnc_tpu_torch.tensornetwork.partitioning.partition_tensor_network`
    does.

    ``communication_path``: a caller-supplied replace-format fan-in
    over COMPACTED block positions (blocks sorted by id after dropping
    empties — identical to raw ids only for dense assignments, which
    tree-cut plans guarantee) — skips the scheme. The path is validated
    fully: exactly ``k-1`` pairs forming a replace-left sequence over
    the ``k`` compacted blocks, every referenced slot still live.

    ``cost_model``: as in :func:`compute_solution` — latencies and the
    returned costs move to predicted seconds.
    """
    blocks: dict[int, list] = {}
    for t, b in zip(tensor.tensors, partitioning):
        blocks.setdefault(b, []).append(t)
    present = sorted(blocks)

    nested: dict[int, ContractionPath] = {}
    latency_map: dict[int, float] = {}
    local_steps: dict[int, float] = {}
    children = []
    children_tensors = []
    for idx, b in enumerate(present):
        child = CompositeTensor(blocks[b])
        children.append(child)
        children_tensors.append(child.external_tensor())
        local = ContractionPath.simple(list(local_paths[b]))
        nested[idx] = local
        local_cost, _ = contract_path_cost(child.tensors, local, True)
        latency_map[idx] = local_cost
        local_steps[idx] = float(len(local.toplevel))
    if cost_model is not None:
        from tnc_tpu_torch.contractionpath.communication_schemes import (
            calibrated_latency_map,
        )

        latency_map = calibrated_latency_map(
            latency_map, cost_model, local_steps
        )

    if communication_path is None:
        communication_path = communication_scheme.communication_path(
            children_tensors, latency_map, rng, cost_model=cost_model
        )
    else:
        communication_path = list(communication_path)
        k = len(children_tensors)
        # full replace-left validation: the fan-in must contract k blocks
        # down to one, so it is exactly k-1 pairs over live compacted
        # block positions (the result replaces slot ``a``; slot ``b`` is
        # consumed). Bounds checks alone let a stale plan reference a
        # consumed slot and silently contract garbage.
        if len(communication_path) != k - 1:
            raise ValueError(
                f"communication_path has {len(communication_path)} pairs; "
                f"a fan-in over {k} compacted blocks needs exactly {k - 1}"
            )
        live = set(range(k))
        for a, b in communication_path:
            if not (0 <= a < k and 0 <= b < k):
                raise ValueError(
                    f"communication_path index ({a}, {b}) outside the "
                    f"compacted block space of {k} blocks"
                )
            if a == b:
                raise ValueError(
                    f"communication_path pair ({a}, {b}) contracts a slot "
                    "with itself"
                )
            if a not in live or b not in live:
                dead = a if a not in live else b
                raise ValueError(
                    f"communication_path pair ({a}, {b}) references slot "
                    f"{dead}, already consumed by an earlier pair"
                )
            live.discard(b)
    tensor_costs = [latency_map[i] for i in range(len(children_tensors))]
    (parallel_cost, sum_cost), _ = communication_path_op_costs(
        children_tensors, communication_path, True, tensor_costs,
        cost_function=_fanin_cost_function(cost_model),
    )

    partitioned = CompositeTensor(children)
    final_path = ContractionPath(nested, communication_path)
    return partitioned, final_path, parallel_cost, sum_cost
