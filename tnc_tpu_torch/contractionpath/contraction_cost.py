"""Analytic cost models for contraction paths (the port's copy of
``tnc_tpu.contractionpath.contraction_cost``, trimmed to what the
:class:`~tnc_tpu_torch.contractionpath.paths.greedy.Greedy` and
:class:`~tnc_tpu_torch.contractionpath.paths.hyper.Hyperoptimizer`
finders, the slicing scorers, the path result and the partitioned
planner call).

Flops and peak memory are predicted *before* any kernel runs. All costs
are floats — Sycamore-class networks overflow 64-bit integers.

- :func:`contract_cost_tensors` — complex-op count
  ``((s-1)*2 + s*6) * |out|`` where ``s = |shared|``
- :func:`contract_op_cost_tensors` — naive op count = product of the union
  dims
- :func:`contract_size_tensors` — ``|out| + |a| + |b|`` elements;
  ``_bytes`` variant multiplies by 16 (complex128)
- :func:`communication_path_cost` / :func:`communication_path_op_costs`
  — a fan-in path's critical-path and serial cost with per-input start
  latencies; :func:`compute_memory_requirements` — a nested path's peak
- :func:`greedy_cost_fn` — the greedy finder's pair-scoring heuristics.
- :class:`PathObjective` / :class:`FlopsObjective` /
  :class:`SizeObjective` — the path-level ranking a trial-based finder
  minimizes;
- :class:`CalibratedObjective` — the same interface priced in **predicted
  seconds** under a fitted
  :class:`~tnc_tpu_torch.obs.calibrate.CalibratedCostModel` (per-step
  flops / bytes / launch-constant pricing);
- :func:`resolve_objective` — a ``minimize`` argument as an objective.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

from tnc_tpu_torch.contractionpath.contraction_path import ContractionPath
from tnc_tpu_torch.tensornetwork.tensor import CompositeTensor, LeafTensor, Tensor

COMPLEX_BYTES = 16.0

CostFn = Callable[[LeafTensor, LeafTensor], float]


def contract_cost_tensors(t1: LeafTensor, t2: LeafTensor) -> float:
    """Complex-operation count of contracting ``t1`` with ``t2``.

    >>> from tnc_tpu_torch.tensornetwork.tensor import LeafTensor
    >>> a = LeafTensor([0, 1], [2, 3])   # shares leg 1 (dim 3) with b
    >>> b = LeafTensor([1, 2], [3, 4])
    >>> contract_cost_tensors(a, b)      # ((3-1)*2 + 3*6) * (2*4)
    176.0
    """
    final_size = (t1 ^ t2).size()
    shared_size = (t1 & t2).size()
    return ((shared_size - 1.0) * 2.0 + shared_size * 6.0) * final_size


def contract_op_cost_tensors(t1: LeafTensor, t2: LeafTensor) -> float:
    """Naive operation count: product of all dims in the union.

    >>> from tnc_tpu_torch.tensornetwork.tensor import LeafTensor
    >>> contract_op_cost_tensors(LeafTensor([0, 1], [2, 3]), LeafTensor([1, 2], [3, 4]))
    24.0
    """
    return (t1 | t2).size()


def contract_size_tensors(t1: LeafTensor, t2: LeafTensor) -> float:
    """Elements live during the pairwise contraction: out + in1 + in2.

    >>> from tnc_tpu_torch.tensornetwork.tensor import LeafTensor
    >>> contract_size_tensors(LeafTensor([0, 1], [2, 3]), LeafTensor([1, 2], [3, 4]))
    26.0
    """
    return (t1 ^ t2).size() + t1.size() + t2.size()


def contract_size_tensors_bytes(t1: LeafTensor, t2: LeafTensor) -> float:
    return contract_size_tensors(t1, t2) * COMPLEX_BYTES


def _as_external_leaf(t: Tensor) -> LeafTensor:
    return t.external_tensor() if isinstance(t, CompositeTensor) else t


def _contract_path_custom_cost(
    inputs: Sequence[Tensor],
    contract_path: ContractionPath,
    cost_function: CostFn,
    size_function: CostFn,
) -> tuple[float, float]:
    op_cost = 0.0
    mem_cost = 0.0
    tensors: list[LeafTensor | Tensor] = list(inputs)

    for i, nested_path in contract_path.nested.items():
        child = tensors[i]
        if not isinstance(child, CompositeTensor):
            raise TypeError(f"nested path at {i} targets a non-composite tensor")
        nested_op, nested_mem = _contract_path_custom_cost(
            child.tensors, nested_path, cost_function, size_function
        )
        op_cost += nested_op
        mem_cost = max(mem_cost, nested_mem)
        tensors[i] = child.external_tensor()

    for i, j in contract_path.toplevel:
        ti = _as_external_leaf(tensors[i])
        tj = _as_external_leaf(tensors[j])
        op_cost += cost_function(ti, tj)
        mem_cost = max(mem_cost, size_function(ti, tj))
        tensors[i] = ti ^ tj

    return op_cost, mem_cost


def contract_path_cost(
    inputs: Sequence[Tensor],
    contract_path: ContractionPath,
    only_count_ops: bool = False,
) -> tuple[float, float]:
    """(op cost, peak element memory) of a nested replace-left path
    (``contraction_cost.rs:101-151``).
    """
    cost_function = contract_op_cost_tensors if only_count_ops else contract_cost_tensors
    return _contract_path_custom_cost(
        inputs, contract_path, cost_function, contract_size_tensors
    )


def communication_path_cost(
    inputs: Sequence[LeafTensor],
    contract_path: Sequence[tuple[int, int]],
    only_count_ops: bool = False,
    only_critical_path: bool = True,
    tensor_cost: Sequence[float] | None = None,
    cost_function: CostFn | None = None,
) -> tuple[float, float]:
    """Cost of a flat (communication) path with per-input start latencies.

    With ``only_critical_path`` the accumulated cost of a contraction is
    ``cost(i,j) + max(latency_i, latency_j)`` — the parallel makespan;
    otherwise latencies add — the serial sum (``contraction_cost.rs:178-244``).

    ``cost_function`` overrides the per-pair cost (e.g. a
    :class:`CalibratedObjective`'s seconds-domain ``pair_cost``, with
    ``tensor_cost`` latencies in seconds to match).
    """
    if cost_function is None:
        cost_function = (
            contract_op_cost_tensors if only_count_ops else contract_cost_tensors
        )
    if tensor_cost is not None:
        if len(tensor_cost) != len(inputs):
            raise ValueError("tensor_cost length must match inputs")
        latencies = list(tensor_cost)
    else:
        latencies = [0.0] * len(inputs)

    if len(inputs) == 1:
        return latencies[0], latencies[0]

    tensors = [t.copy() for t in inputs]
    op_cost = 0.0
    mem_cost = 0.0
    for i, j in contract_path:
        out = tensors[i] ^ tensors[j]
        mem_cost = max(mem_cost, contract_size_tensors(tensors[i], tensors[j]))
        step = cost_function(tensors[i], tensors[j])
        if only_critical_path:
            op_cost = step + max(latencies[i], latencies[j])
        else:
            op_cost = step + latencies[i] + latencies[j]
        latencies[i] = op_cost
        tensors[i] = out
    return op_cost, mem_cost


def communication_path_op_costs(
    inputs: Sequence[LeafTensor],
    contract_path: Sequence[tuple[int, int]],
    only_count_ops: bool = False,
    tensor_cost: Sequence[float] | None = None,
    cost_function: CostFn | None = None,
) -> tuple[tuple[float, float], float]:
    """((critical-path cost, sum cost), peak memory)
    (``contraction_cost.rs:156-167``).
    """
    parallel_cost, _ = communication_path_cost(
        inputs, contract_path, only_count_ops, True, tensor_cost,
        cost_function,
    )
    serial_cost, mem_cost = communication_path_cost(
        inputs, contract_path, only_count_ops, False, tensor_cost,
        cost_function,
    )
    return (parallel_cost, serial_cost), mem_cost


def compute_memory_requirements(
    inputs: Sequence[Tensor],
    contract_path: ContractionPath,
    memory_estimator: CostFn = contract_size_tensors,
) -> float:
    """Peak memory of a nested path under ``memory_estimator``
    (``contraction_cost.rs:254-264``).
    """

    def zero(_a: LeafTensor, _b: LeafTensor) -> float:
        return 0.0

    _, mem = _contract_path_custom_cost(inputs, contract_path, zero, memory_estimator)
    return mem


# ---------------------------------------------------------------------------
# Greedy pair-scoring cost functions (arXiv:2405.09644)


#: registry of greedy pair heuristics: name -> factory(alpha) -> fn.
#: Each fn maps (out_size, size_a, size_b) to a score; the greedy finder
#: repeatedly contracts the minimum-score pair.
GREEDY_COST_KINDS = ("memory-removed", "memory-removed-log", "size")


def greedy_cost_fn(
    kind: str = "memory-removed", alpha: float = 1.0
) -> Callable[[float, float, float], float]:
    """A pair-scoring function for the greedy finder.

    The improved greedy cost functions of arXiv:2405.09644 generalize
    cotengra's memory-removed heuristic: ``alpha`` weights how strongly
    freeing the input tensors is rewarded, and the log-domain variant
    compares tensor *ranks* instead of raw sizes (robust when bond
    dimensions span orders of magnitude).

    - ``memory-removed``: ``size(out) - alpha * (size(a) + size(b))``
      (``alpha=1`` is the classic default the reference reaches through
      cotengrust);
    - ``memory-removed-log``: ``log2(1+size(out)) - alpha *
      log2(1 + size(a) + size(b))``;
    - ``size``: ``size(out)`` — greedily keep intermediates small,
      ignoring what is freed.

    >>> fn = greedy_cost_fn("memory-removed")
    >>> fn(16.0, 8.0, 8.0)
    0.0
    >>> greedy_cost_fn("size")(16.0, 8.0, 8.0)
    16.0
    """
    if kind == "memory-removed":
        if alpha == 1.0:
            return lambda out, a, b: out - a - b
        return lambda out, a, b: out - alpha * (a + b)
    if kind == "memory-removed-log":
        return lambda out, a, b: (
            math.log2(1.0 + out) - alpha * math.log2(1.0 + a + b)
        )
    if kind == "size":
        return lambda out, a, b: out
    raise ValueError(
        f"unknown greedy cost function {kind!r}; expected one of "
        f"{GREEDY_COST_KINDS}"
    )


# ---------------------------------------------------------------------------
# Pluggable path objectives


class PathObjective:
    """What a trial-based pathfinder minimizes, as a pluggable strategy.

    Implementations supply :meth:`pair_cost` — the cost charged for one
    pairwise contraction — and inherit path-level aggregation. The
    *domain* of the returned numbers is the implementation's choice
    (flop counts, predicted seconds); finders only compare candidates
    under ONE objective, so any monotone scale works.
    """

    #: short name recorded in plan artifacts (plan cache, bench JSON)
    name = "abstract"

    def pair_cost(self, t1: LeafTensor, t2: LeafTensor) -> float:
        raise NotImplementedError

    def path_cost(
        self, inputs: Sequence[Tensor], contract_path: ContractionPath
    ) -> float:
        """Total cost of a (possibly nested) replace path."""
        cost, _ = _contract_path_custom_cost(
            inputs, contract_path, self.pair_cost, contract_size_tensors
        )
        return cost

    def ssa_path_cost(
        self, inputs: Sequence[Tensor], ssa_pairs: Sequence[tuple[int, int]]
    ) -> float:
        """Total cost of a flat SSA pair path (the finders' native
        candidate format)."""
        from tnc_tpu_torch.contractionpath.contraction_path import (
            ssa_replace_ordering,
        )

        return self.path_cost(
            inputs,
            ssa_replace_ordering(ContractionPath.simple(list(ssa_pairs))),
        )

    def sliced_path_cost(
        self,
        inputs: Sequence[LeafTensor],
        replace_pairs: Sequence[tuple[int, int]],
        slicing,
    ) -> float:
        """Cost of a flat path executed as a slice loop. The base
        implementation charges the naive ``num_slices x per-slice`` flop
        total (the historical slicing-aware score, valid for the flops
        and size objectives alike since both rank by the same slicing
        overhead)."""
        from tnc_tpu_torch.contractionpath.slicing import sliced_flops

        return sliced_flops(inputs, list(replace_pairs), slicing)


class FlopsObjective(PathObjective):
    """Minimize naive op counts — the historical default everywhere.

    >>> a, b = LeafTensor([0, 1], [2, 3]), LeafTensor([1, 2], [3, 4])
    >>> FlopsObjective().pair_cost(a, b)
    24.0
    """

    name = "flops"

    def pair_cost(self, t1: LeafTensor, t2: LeafTensor) -> float:
        return contract_op_cost_tensors(t1, t2)


class SizeObjective(PathObjective):
    """Minimize the peak intermediate size (elements). ``path_cost``
    returns the peak, not a sum — candidates still compare correctly
    because every finder only ranks under one objective at a time."""

    name = "size"

    def pair_cost(self, t1: LeafTensor, t2: LeafTensor) -> float:
        return contract_size_tensors(t1, t2)

    def path_cost(
        self, inputs: Sequence[Tensor], contract_path: ContractionPath
    ) -> float:
        _, mem = _contract_path_custom_cost(
            inputs, contract_path, self.pair_cost, contract_size_tensors
        )
        return mem


class CalibratedObjective(PathObjective):
    """Predicted **seconds** under a fitted device model — the
    plan→measure→replan loop's objective.

    Each pairwise contraction is priced as one launched step:
    ``flops / flops_per_s + bytes / bytes_per_s + dispatch_s`` (the
    per-step constant raw flop counts are blind to, cf.
    :meth:`~tnc_tpu_torch.obs.calibrate.CalibratedCostModel.
    dispatch_equivalent_flops`). A path of many tiny steps therefore
    loses to a path of few large ones even at equal flops, and sliced
    plans are priced with the hoisted ``prelude + num_slices x residual``
    seconds formula.

    >>> from tnc_tpu_torch.obs.calibrate import CalibratedCostModel
    >>> m = CalibratedCostModel(flops_per_s=1e9, dispatch_s=1e-3)
    >>> obj = CalibratedObjective(m)
    >>> a, b = LeafTensor([0, 1], [2, 3]), LeafTensor([1, 2], [3, 4])
    >>> round(obj.pair_cost(a, b), 9)   # 24 flops + one launch
    0.001000024
    """

    name = "calibrated"

    def __init__(self, cost_model, bytes_per_elem: float = COMPLEX_BYTES):
        if cost_model is None:
            raise ValueError("CalibratedObjective requires a cost model")
        self.cost_model = cost_model
        self.bytes_per_elem = float(bytes_per_elem)

    def pair_cost(self, t1: LeafTensor, t2: LeafTensor) -> float:
        flops = contract_op_cost_tensors(t1, t2)
        nbytes = contract_size_tensors(t1, t2) * self.bytes_per_elem
        return self.cost_model.op_seconds(flops, nbytes)

    def sliced_path_cost(
        self,
        inputs: Sequence[LeafTensor],
        replace_pairs: Sequence[tuple[int, int]],
        slicing,
    ) -> float:
        from tnc_tpu_torch.contractionpath.slicing import (
            StemAccountant,
            _make_replayer,
        )

        pairs = list(replace_pairs)
        acct = StemAccountant(inputs, pairs, cost_model=self.cost_model)
        removed = set(slicing.legs)
        per_slice = _make_replayer(inputs, pairs).flops(removed)
        return acct.hoisted_cost(removed, per_slice, slicing.num_slices)


def resolve_objective(minimize) -> PathObjective:
    """Normalize a ``minimize`` argument — an objective instance, or the
    legacy strings ``"flops"`` / ``"size"`` — to a :class:`PathObjective`.

    >>> resolve_objective("flops").name
    'flops'
    >>> resolve_objective(SizeObjective()).name
    'size'
    """
    if isinstance(minimize, PathObjective):
        return minimize
    if minimize in (None, "flops"):
        return FlopsObjective()
    if minimize == "size":
        return SizeObjective()
    raise ValueError(
        f"unknown objective {minimize!r}; expected 'flops', 'size', or a "
        "PathObjective instance"
    )
