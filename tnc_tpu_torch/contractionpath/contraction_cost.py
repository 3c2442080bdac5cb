"""Analytic cost models for contraction paths (the port's copy of
``tnc_tpu.contractionpath.contraction_cost``, trimmed to what the
:class:`~tnc_tpu_torch.contractionpath.paths.greedy.Greedy` finder and
the path result call).

Flops and peak memory are predicted *before* any kernel runs. All costs
are floats — Sycamore-class networks overflow 64-bit integers.

- :func:`contract_cost_tensors` — complex-op count
  ``((s-1)*2 + s*6) * |out|`` where ``s = |shared|``
- :func:`contract_op_cost_tensors` — naive op count = product of the union
  dims
- :func:`contract_size_tensors` — ``|out| + |a| + |b|`` elements
- :func:`greedy_cost_fn` — the greedy finder's pair-scoring heuristics.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

from tnc_tpu_torch.contractionpath.contraction_path import ContractionPath
from tnc_tpu_torch.tensornetwork.tensor import CompositeTensor, LeafTensor, Tensor

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
