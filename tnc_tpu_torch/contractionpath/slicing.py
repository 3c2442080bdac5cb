"""Contraction slicing: trade flops for peak memory (the port's copy of
``tnc_tpu.contractionpath.slicing``, without the hoist-aware accounting
and the joint search).

Selected *contracted* legs are fixed to an index value, the contraction
runs once per index combination, and the results are summed. Every slice
is a program of the same shapes, so the device loop plans its kernels
once and runs them per slice
(:meth:`tnc_tpu_torch.ops.backends.TorchBackend.execute_sliced`).

The slice-leg selection is the standard greedy heuristic (as used by
cotengra's SliceFinder): repeatedly slice the leg that most reduces the
predicted peak intermediate size, until the peak fits the target. Slice
sets are scored by the naive per-slice cost times the slice count: the
port runs every slice in full, with no hoisted stem.

The path is replayed in Python only; the reference picks its native
replayer when it is built, and the tests hold the two to the same legs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

from tnc_tpu_torch.tensornetwork.tensor import LeafTensor

__all__ = [
    "Slicing",
    "find_slicing",
    "sliced_flops",
    "sliced_peak",
]


@dataclass(frozen=True)
class Slicing:
    """A set of sliced legs and their dimensions."""

    legs: tuple[int, ...]
    dims: tuple[int, ...]

    @property
    def num_slices(self) -> int:
        n = 1
        for d in self.dims:
            n *= d
        return n

    def overhead(self) -> float:
        """Upper bound on the flops multiplier caused by slicing."""
        return float(self.num_slices)

    def to_obj(self) -> dict:
        """JSON-able form (a plan persists path + slicing as plain JSON,
        never pickle)."""
        return {"legs": list(self.legs), "dims": list(self.dims)}

    @classmethod
    def from_obj(cls, obj: dict) -> "Slicing":
        """Inverse of :meth:`to_obj`.

        >>> Slicing.from_obj(Slicing((3, 7), (2, 2)).to_obj())
        Slicing(legs=(3, 7), dims=(2, 2))
        """
        return cls(tuple(int(l) for l in obj["legs"]),
                   tuple(int(d) for d in obj["dims"]))


class _PyReplayer:
    """Replays a flat replace path with some legs removed: peak step size,
    per-leg peak participation and per-slice op cost."""

    def __init__(self, inputs, replace_path):
        self._inputs = inputs
        self._path = replace_path

    def sizes(self, removed):
        return _replay_sizes(self._inputs, self._path, removed)

    def flops(self, removed):
        return _reduced_flops(self._inputs, self._path, removed)

    def peak(self, removed):
        peak, _ = _replay_sizes(self._inputs, self._path, removed)
        return peak


def _make_replayer(inputs, replace_path):
    """The path replayer. The reference prefers a native one
    (``slicereplay.cpp``) when it is built; the port replays in Python."""
    return _PyReplayer(inputs, replace_path)


def _reduced_tensors(inputs: Sequence[LeafTensor], removed: set[int]) -> list[LeafTensor]:
    return [
        LeafTensor(
            [l for l in t.legs if l not in removed],
            [d for l, d in t.edges() if l not in removed],
        )
        for t in inputs
    ]


def _replay_sizes(
    inputs: Sequence[LeafTensor],
    replace_path: Sequence[tuple[int, int]],
    removed: set[int],
) -> tuple[float, dict[int, float]]:
    """Peak step size of a flat replace path with ``removed`` legs sliced
    away, and per-leg 'presence in peak step' accounting.

    Returns (peak_size, leg -> largest step size that leg participates in).
    """
    tensors = _reduced_tensors(inputs, removed)
    peak = 0.0
    leg_peak: dict[int, float] = {}
    for i, j in replace_path:
        ti, tj = tensors[i], tensors[j]
        out = ti ^ tj
        step = out.size() + ti.size() + tj.size()
        peak = max(peak, step)
        for t in (ti, tj, out):
            for leg in t.legs:
                if step > leg_peak.get(leg, 0.0):
                    leg_peak[leg] = step
        tensors[i] = out
    return peak, leg_peak


def _reduced_flops(
    inputs: Sequence[LeafTensor],
    replace_path: Sequence[tuple[int, int]],
    removed: set[int],
) -> float:
    """Per-slice naive op cost of a replace path with ``removed`` legs
    pinned (helper for slice-leg scoring)."""
    tensors = _reduced_tensors(inputs, removed)
    total = 0.0
    for i, j in replace_path:
        total += (tensors[i] | tensors[j]).size()
        tensors[i] = tensors[i] ^ tensors[j]
    return total


def find_slicing(
    inputs: Sequence[LeafTensor],
    replace_path: Sequence[tuple[int, int]],
    target_size: float,
    max_slices: int = 1 << 24,
) -> Slicing:
    """Greedily pick legs to slice until the path's peak intermediate size
    (in elements, out+in1+in2 model) is at most ``target_size``.

    Only *closed* legs (absent from the final result) are sliceable.
    Raises if the target cannot be met within ``max_slices``.

    >>> ts = [LeafTensor.from_const([0, 1], 4), LeafTensor.from_const([1, 2], 4),
    ...       LeafTensor.from_const([2, 0], 4)]   # closed triangle
    >>> s = find_slicing(ts, [(0, 1), (0, 2)], target_size=12)
    >>> s.num_slices >= 4 and len(s.legs) >= 1
    True
    """
    dims: dict[int, int] = {}
    open_legs: set[int] = set()
    for t in inputs:
        for leg, dim in t.edges():
            dims[leg] = dim
            if leg in open_legs:
                open_legs.discard(leg)
            else:
                open_legs.add(leg)

    removed: set[int] = set()
    num_slices = 1
    replayer = _make_replayer(inputs, replace_path)
    while True:
        peak, leg_peak = replayer.sizes(removed)
        if peak <= target_size:
            break
        # candidate legs: participate in the peak-sized steps, closed, unsliced
        candidates = [
            (size, dims[leg], leg)
            for leg, size in leg_peak.items()
            if leg not in removed and leg not in open_legs and dims[leg] > 1
        ]
        if not candidates:
            raise ValueError(
                f"No sliceable legs left but peak {peak:.3e} > target {target_size:.3e}"
            )
        # slice the leg participating in the largest step; among those,
        # prefer larger dims (fewer legs for the same memory reduction)
        candidates.sort(key=lambda c: (-c[0], -c[1], c[2]))
        _, dim, leg = candidates[0]
        removed.add(leg)
        num_slices *= dim
        if num_slices > max_slices:
            raise ValueError(
                f"Slicing needs more than {max_slices} slices to reach "
                f"target {target_size:.3e}"
            )

    ordered = sorted(removed)
    return Slicing(tuple(ordered), tuple(dims[l] for l in ordered))


def sliced_flops(
    inputs: Sequence[LeafTensor],
    replace_path: Sequence[tuple[int, int]],
    slicing: Slicing,
) -> float:
    """Total naive op cost across all slices."""
    replayer = _make_replayer(inputs, replace_path)
    return replayer.flops(set(slicing.legs)) * slicing.num_slices


def sliced_peak(
    inputs: Sequence[LeafTensor],
    replace_path: Sequence[tuple[int, int]],
    slicing: Slicing,
) -> float:
    """Peak step size (elements, out+in1+in2) of the path with
    ``slicing.legs`` removed — the memory the executor actually pays
    per slice.

    >>> ts = [LeafTensor.from_const([0, 1], 4), LeafTensor.from_const([1, 2], 4),
    ...       LeafTensor.from_const([2, 0], 4)]
    >>> s = find_slicing(ts, [(0, 1), (0, 2)], target_size=12)
    >>> sliced_peak(ts, [(0, 1), (0, 2)], s) <= 12.0
    True
    """
    return _make_replayer(inputs, replace_path).peak(set(slicing.legs))
