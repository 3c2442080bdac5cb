"""Contraction slicing: trade flops for peak memory (the port's copy of
``tnc_tpu.contractionpath.slicing``).

Selected *contracted* legs are fixed to an index value, the contraction
runs once per index combination, and the results are summed. Every slice
is a program of the same shapes, so the device loop plans its kernels
once and runs them per slice
(:meth:`tnc_tpu_torch.ops.backends.TorchBackend.execute_sliced`).

The slice-leg selection is the standard greedy heuristic (as used by
cotengra's SliceFinder): repeatedly slice the leg that most reduces the
predicted peak intermediate size, until the peak fits the target.
:func:`find_parallel_slicing` extends a slicing until its slice count
divides over the devices of a slice-parallel run
(:mod:`tnc_tpu_torch.parallel.sliced_parallel`).
:func:`slice_and_reconfigure` interleaves that with subtree
reconfiguration, scoring legs by the hoisted cost: the executors run the
slice-invariant stem once (:mod:`tnc_tpu_torch.ops.hoist`), so a
candidate set costs ``invariant_flops + num_slices * residual_flops``
(:class:`StemAccountant`, :func:`hoisted_sliced_flops`).

The path is replayed by the native replayer
(``partitioning/native/slicereplay.cpp``) where it is built, else by the
Python loops below, its oracle.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

from tnc_tpu_torch import obs
from tnc_tpu_torch.contractionpath.contraction_path import ContractionPath
from tnc_tpu_torch.tensornetwork.tensor import LeafTensor

__all__ = [
    "Slicing",
    "StemAccountant",
    "SlicedCostEvaluator",
    "find_parallel_slicing",
    "find_slicing",
    "flat_replace_path",
    "greedy_slice_to_target",
    "hoisted_sliced_flops",
    "joint_slice_search",
    "slice_and_reconfigure",
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
    """Python-backed replayer with the native interface, so call sites
    dispatch unconditionally (the two arms cannot diverge)."""

    def __init__(self, inputs, replace_path):
        self._inputs = inputs
        self._path = replace_path

    def sizes(self, removed):
        return _replay_sizes(self._inputs, self._path, removed)

    def flops(self, removed):
        return _reduced_flops(self._inputs, self._path, removed)

    def peak_and_flops(self, removed):
        peak, _ = _replay_sizes(self._inputs, self._path, removed)
        return peak, _reduced_flops(self._inputs, self._path, removed)

    def peak(self, removed):
        peak, _ = _replay_sizes(self._inputs, self._path, removed)
        return peak


def _make_replayer(inputs, replace_path):
    """Path replayer: native (``native/slicereplay.cpp``) when
    available, else the Python loops below (its oracle and fallback).

    Slicing-aware candidate scoring replays the path thousands of times
    per plan."""
    from tnc_tpu_torch.partitioning.native_binding import SlicedReplayer

    r = SlicedReplayer(inputs, replace_path)
    return r if r.available else _PyReplayer(inputs, replace_path)


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


class StemAccountant:
    """Hoist-aware flop accounting for candidate slice sets.

    One full-dims replay of the path precomputes, per step, its naive op
    cost and the set of legs contributed by the leaves in its subtree.
    A step is *variant* under a removal set R iff its contributed-leg
    set intersects R (a value computed from a sliced leaf stays
    per-slice even after the sliced leg is contracted away); invariant
    steps never touch a removed leg, so their cost is independent of R.
    ``invariant_flops(R)`` is then an O(steps) mask-and-sum per query —
    cheap enough for the planner's per-candidate scoring loops, on top
    of the (native) replayer's total-flops query.

    ``cost_model`` (a :class:`tnc_tpu_torch.obs.calibrate.
    CalibratedCostModel` fitted from measured step spans) switches
    :meth:`hoisted_cost` from raw flop counts to predicted *seconds* —
    including the per-slice launch overhead raw op counts are blind to, so
    candidate scoring stops treating ever-deeper slicing as free (the plan
    → measure → replan loop).
    """

    def __init__(
        self,
        inputs: Sequence[LeafTensor],
        replace_path: Sequence[tuple[int, int]],
        cost_model=None,
    ):
        import numpy as np

        self._cost_model = cost_model

        tensors = [t.copy() for t in inputs]
        contrib: list[frozenset[int]] = [
            frozenset(t.legs) for t in inputs
        ]
        costs: list[float] = []
        step_legs: list[frozenset[int]] = []
        for i, j in replace_path:
            costs.append((tensors[i] | tensors[j]).size())
            merged = contrib[i] | contrib[j]
            step_legs.append(merged)
            tensors[i] = tensors[i] ^ tensors[j]
            contrib[i] = merged
        self._costs = np.asarray(costs, dtype=np.float64)
        self.total_flops = float(self._costs.sum())
        n = len(costs)
        self._leg_steps: dict[int, "np.ndarray"] = {}
        for idx, legs in enumerate(step_legs):
            for leg in legs:
                mask = self._leg_steps.get(leg)
                if mask is None:
                    mask = np.zeros(n, dtype=bool)
                    self._leg_steps[leg] = mask
                mask[idx] = True

    def _variant_mask(self, removed):
        """Boolean step mask (True = variant under ``removed``), or
        ``None`` when no removed leg touches any step."""
        variant = None
        for leg in removed:
            mask = self._leg_steps.get(leg)
            if mask is None:
                continue
            variant = mask.copy() if variant is None else (variant | mask)
        return variant

    def invariant_flops(self, removed) -> float:
        """Flops of the steps that stay slice-invariant with ``removed``
        legs sliced — paid once under hoisted execution."""
        variant = self._variant_mask(removed)
        if variant is None:
            return self.total_flops
        return float(self._costs[~variant].sum())

    def hoist_split(
        self, removed, per_slice_flops: float
    ) -> tuple[float, float]:
        """(invariant, per-slice residual) flops, mirroring the compiled
        hoist pass exactly: :func:`tnc_tpu_torch.ops.hoist.
        hoist_sliced_program` degrades to a no-op — nothing cached,
        everything in the per-slice residual — when NO step is variant
        (1-slice plans: empty removal set) or when EVERY step is, and
        this accounting degrades identically. Keeping the two
        implementations in lockstep is what lets bench.py cross-check
        them without special-casing the 1-slice plan."""
        variant = self._variant_mask(removed)
        n_var = 0 if variant is None else int(variant.sum())
        if n_var == 0 or n_var == len(self._costs):
            return 0.0, per_slice_flops
        inv = float(self._costs[~variant].sum())
        return inv, max(per_slice_flops - inv, 0.0)

    def hoisted_cost(
        self, removed, per_slice_flops: float, num_slices: int
    ) -> float:
        """``invariant + num_slices * residual`` given the replayer's
        per-slice total ``per_slice_flops`` for the same removal set
        (split per :meth:`hoist_split`, so a removal set the hoist pass
        would no-op on is charged the full per-slice cost every slice).
        With a calibrated ``cost_model`` the same split is priced in
        predicted seconds (residual launches included) instead of raw
        flops — both are valid scoring keys (monotone in the work), so
        callers compare candidates without caring which one is active.
        """
        inv, residual = self.hoist_split(removed, per_slice_flops)
        if self._cost_model is not None:
            # the fitted launch overhead is per STEP: a slice runs every
            # variant step, the prelude every invariant one
            variant = self._variant_mask(removed)
            n = len(self._costs)
            n_var = 0 if variant is None else int(variant.sum())
            if n_var == 0 or n_var == n:  # no-op hoist: all steps loop
                n_var = n
            return self._cost_model.sliced_cost(
                inv,
                residual,
                num_slices,
                steps_per_slice=max(float(n_var), 1.0),
                prelude_steps=max(float(n - n_var), 1.0),
            )
        return inv + float(num_slices) * residual


def hoisted_sliced_flops(
    inputs: Sequence[LeafTensor],
    replace_path: Sequence[tuple[int, int]],
    slicing: Slicing,
) -> tuple[float, float, float]:
    """(invariant_flops, per-slice residual_flops, hoisted total cost)
    of a sliced path under stem-hoisting execution. The naive executor
    pays ``num_slices * (invariant + residual)`` =
    :func:`sliced_flops`; the hoisted one ``invariant + num_slices *
    residual``. The split follows :meth:`StemAccountant.hoist_split`,
    so plans the compiled hoist pass no-ops on (1-slice plans, or
    all-variant step lists) report ``invariant == 0`` here too.

    >>> from tnc_tpu_torch.tensornetwork.tensor import LeafTensor
    >>> ts = [LeafTensor.from_const([0, 1], 4), LeafTensor.from_const([1, 2], 4),
    ...       LeafTensor.from_const([2, 3], 4), LeafTensor.from_const([3, 0], 4)]
    >>> path = [(0, 3), (0, 1), (0, 2)]   # (0, 3) touches no sliced leg
    >>> s = Slicing((2,), (4,))
    >>> inv, res, total = hoisted_sliced_flops(ts, path, s)
    >>> inv > 0 and total < sliced_flops(ts, path, s)
    True
    >>> hoisted_sliced_flops(ts, path, Slicing((), ()))[0]  # 1-slice: no-op
    0.0
    """
    removed = set(slicing.legs)
    acct = StemAccountant(inputs, replace_path)
    per_slice = _make_replayer(inputs, replace_path).flops(removed)
    inv, residual = acct.hoist_split(removed, per_slice)
    return inv, residual, inv + slicing.num_slices * residual


@obs.traced("plan.find_slicing")
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


@obs.traced("plan.find_parallel_slicing")
def find_parallel_slicing(
    inputs: Sequence[LeafTensor],
    replace_path: Sequence[tuple[int, int]],
    n_devices: int,
    target_size: float | None = None,
    max_extra_legs: int = 8,
    base: Slicing | None = None,
    cost_model=None,
) -> Slicing | None:
    """A slicing suitable for **slice-parallel** execution
    (:func:`tnc_tpu_torch.parallel.distributed_sliced_contraction`): at
    least ``n_devices`` slices, count divisible by ``n_devices``, and — when
    ``target_size`` is given — peak intermediate size within it.

    Memory slicing picks legs by peak reduction (:func:`find_slicing`),
    or comes in as ``base`` (e.g. a :func:`slice_and_reconfigure` result
    to extend with divisibility legs only); the extra legs sliced purely
    for parallelism are picked to minimize the total sliced flops under
    hoisted execution (the overhead the devices must amortize). Returns
    ``None`` if no divisible slicing exists within ``max_extra_legs``
    extra legs — the caller falls back to partition parallelism.
    ``cost_model`` (a measured
    :class:`~tnc_tpu_torch.obs.calibrate.CalibratedCostModel`) scores the
    extra legs in predicted seconds — per-slice launch overhead included —
    instead of raw flops.

    >>> ts = [LeafTensor.from_const([0, 1], 4), LeafTensor.from_const([1, 2], 4),
    ...       LeafTensor.from_const([2, 0], 4)]   # closed triangle
    >>> s = find_parallel_slicing(ts, [(0, 1), (0, 2)], 4)
    >>> s.num_slices % 4 == 0 and s.num_slices >= 4
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

    if base is not None and target_size is not None:
        # base was planned against its own budget: checking a second
        # target here would be ambiguous
        raise ValueError("pass either base or target_size, not both")
    removed: set[int] = set(base.legs) if base is not None else set()
    if base is None and target_size is not None:
        removed = set(
            find_slicing(inputs, replace_path, target_size, max_slices=1 << 40).legs
        )

    replayer = _make_replayer(inputs, replace_path)
    acct: StemAccountant | None = None  # built at the first extra leg

    def count(legs: set[int]) -> int:
        n = 1
        for leg in legs:
            n *= dims[leg]
        return n

    extra = 0
    while not (count(removed) >= n_devices and count(removed) % n_devices == 0):
        if extra >= max_extra_legs:
            return None
        candidates = [
            leg
            for leg in dims
            if leg not in removed and leg not in open_legs and dims[leg] > 1
        ]
        if not candidates:
            return None
        if acct is None:
            acct = StemAccountant(inputs, replace_path, cost_model=cost_model)
        best = min(
            candidates,
            key=lambda leg: (
                acct.hoisted_cost(
                    removed | {leg},
                    replayer.flops(removed | {leg}),
                    count(removed | {leg}),
                ),
                leg,
            ),
        )
        removed.add(best)
        extra += 1

    ordered = sorted(removed)
    return Slicing(tuple(ordered), tuple(dims[l] for l in ordered))


def flat_replace_path(path_: ContractionPath) -> list[tuple[int, int]]:
    """Toplevel of a simple replace path (slicing operates on flat paths)."""
    if path_.nested:
        raise ValueError("Slicing expects a flat (non-nested) path")
    return list(path_.toplevel)


@obs.traced("plan.slice_and_reconfigure")
def slice_and_reconfigure(
    inputs: Sequence[LeafTensor],
    ssa_path: Sequence[tuple[int, int]],
    target_size: float,
    subtree_size: int = 12,
    reconf_rounds: int = 1,
    final_rounds: int = 8,
    step_budget: float | None = 4.0,
    final_budget: float | None = 45.0,
    max_slices: int = 1 << 26,
    max_leg_candidates: int = 48,
    cost_model=None,
    seed_slices: "Sequence[int] | Slicing | None" = None,
) -> tuple[list[tuple[int, int]], Slicing]:
    """Interleaved slicing + subtree reconfiguration (cotengra's
    ``slicing_reconf`` approach): repeatedly slice a leg of the peak
    step, then repair the flops overhead by re-solving subtrees *in the
    sliced size model* (sliced legs have dim 1).

    Leg selection replays the path once per candidate leg of the peak
    step and picks the (post-slice peak, post-slice flops) minimum —
    pure step-size heuristics pick legs that shrink one wide step while
    a plateau of equally wide steps with different legs survives.

    The repair passes run *uncapped*: flops minimization in the reduced
    model naturally deflates wide intermediates (they dominate the op
    count), while a hard size cap would forbid the DP from touching
    exactly the near-peak subtrees it must repair. The outer loop keeps
    slicing until the genuine replayed peak meets the target, and the
    final deep pass is accepted only if it preserves that bound.

    Returns (replace_path, slicing); the path is valid for the unsliced
    network (slicing only pins index values, it never reorders legs).

    ``cost_model`` (a measured
    :class:`~tnc_tpu_torch.obs.calibrate.CalibratedCostModel`) switches leg
    scoring from hoisted flop counts to predicted seconds, charging each
    extra slice its real launch overhead.

    ``seed_slices`` (legs, or a :class:`Slicing`) warm-starts the
    removal set — the joint hyper search hands its winning slice set
    over so this pass degrades to a thin repair (one reconfigure over
    the pre-reduced model, usually zero candidate-leg searches), and a
    cached plan's slice set warm-starts replanning the same structure.
    Invalid seeds (open legs, dim 1, unknown) are skipped; the loop
    still extends the set when the seeded peak misses the target.
    """
    from tnc_tpu_torch.contractionpath.contraction_path import (
        ssa_replace_ordering,
    )
    from tnc_tpu_torch.contractionpath.contraction_tree import ContractionTree

    tree = ContractionTree.from_ssa_path(inputs, list(ssa_path))
    tree.dims = dict(tree.dims)  # private copy: sliced legs become dim 1

    open_legs: set[int] = set()
    for t in inputs:
        for leg in t.legs:
            open_legs.symmetric_difference_update((leg,))

    dims: dict[int, int] = {}
    for t in inputs:
        for leg, dim in t.edges():
            dims[leg] = dim

    removed: set[int] = set()
    num_slices = 1
    # Seeds restrict the candidate pool, they don't bypass the loop:
    # each round scores only the remaining seed legs (instead of up to
    # max_leg_candidates peak-step legs) with the SAME (peak, hoisted
    # cost) key and the same interleaved repair cadence. Seeding with a
    # cold run's own slice set on the same path therefore replays that
    # run's trajectory — never worse at equal rounds — while skipping
    # most of its candidate-replay cost; once the pool is exhausted the
    # normal search resumes for any legs the seed missed.
    seed_pool: set[int] = set()
    if seed_slices is not None:
        seed_legs = (
            seed_slices.legs
            if isinstance(seed_slices, Slicing)
            else seed_slices
        )
        seed_pool = {
            leg
            for leg in seed_legs
            if leg in dims and leg not in open_legs and dims[leg] > 1
        }
    while True:
        replace = ssa_replace_ordering(
            ContractionPath.simple(tree.to_ssa_path())
        ).toplevel
        # the path changes every round (reconfigure), so the replayer is
        # rebuilt per round and reused across the ~48 candidate trials
        replayer = _make_replayer(inputs, replace)
        peak, leg_peak = replayer.sizes(removed)
        if peak <= target_size:
            break
        # ascending leg id: both replayer arms then see the same
        # candidate order, so truncation and exact-tie '<' picks cannot
        # diverge between native and Python-fallback machines (this is
        # the order the native leg_peak already iterates in, preserving
        # the canonical prewarmed plan)
        seed_pool -= removed
        if seed_pool:
            candidates = sorted(seed_pool)
        else:
            candidates = sorted(
                leg
                for leg, size in leg_peak.items()
                if size >= peak * 0.99
                and leg not in removed
                and leg not in open_legs
                and dims[leg] > 1
            )
        if not candidates:
            # no sliceable leg in the peak step: fall back to any leg
            candidates = sorted(
                leg
                for leg in leg_peak
                if leg not in removed and leg not in open_legs and dims[leg] > 1
            )
        if not candidates:
            raise ValueError(
                f"No sliceable legs left but peak {peak:.3e} > "
                f"target {target_size:.3e}"
            )
        # score candidates by (post-slice peak, hoisted total cost):
        # the executors run the slice-invariant stem once, so a trial's
        # flops component is invariant + num_slices * residual, which
        # prefers legs that keep a large hoistable stem over legs that
        # drag the whole program into the per-slice loop
        acct = StemAccountant(inputs, replace, cost_model=cost_model)
        best_leg = -1
        best_key: tuple[float, float] | None = None
        for leg in candidates[:max_leg_candidates]:
            trial = removed | {leg}
            trial_peak, trial_flops = replayer.peak_and_flops(trial)
            key = (
                trial_peak,
                acct.hoisted_cost(
                    trial, trial_flops, num_slices * dims[leg]
                ),
            )
            if best_key is None or key < best_key:
                best_key = key
                best_leg = leg
        leg = best_leg
        removed.add(leg)
        num_slices *= dims[leg]
        if num_slices > max_slices:
            raise ValueError(
                f"Slicing needs more than {max_slices} slices to reach "
                f"target {target_size:.3e}"
            )
        tree.dims[leg] = 1
        if reconf_rounds > 0:
            tree.reconfigure(
                subtree_size, reconf_rounds, time_budget=step_budget
            )

    if final_rounds > 0 and removed:
        # Deep repair on a copy; keep it only if the peak bound survives.
        refined = tree.copy()
        refined.reconfigure(subtree_size, final_rounds, time_budget=final_budget)
        refined_replace = ssa_replace_ordering(
            ContractionPath.simple(refined.to_ssa_path())
        ).toplevel
        refined_peak = _make_replayer(inputs, refined_replace).peak(removed)
        if refined_peak <= target_size:
            tree = refined

    replace = ssa_replace_ordering(
        ContractionPath.simple(tree.to_ssa_path())
    ).toplevel
    ordered = sorted(removed)
    return list(replace), Slicing(
        tuple(ordered), tuple(dims[l] for l in ordered)
    )


# The incremental sliced-cost evaluator and the joint tree+slice search
# live in their own module but belong to this layer's public surface:
# the evaluator answers the same questions as the replay oracles above
# (pinned bitwise-equal) with O(affected-steps) delta updates, cheap
# enough to run inside every search loop instead of once per finalist.
from tnc_tpu_torch.contractionpath.sliced_cost import (  # noqa: E402
    SlicedCostEvaluator,
    greedy_slice_to_target,
    joint_slice_search,
)
