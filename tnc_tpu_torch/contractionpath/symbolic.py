"""Symbolic contraction plans: a compact, digestable wire format (the
port's copy of ``tnc_tpu.contractionpath.symbolic``; a record either
package writes loads in the other, and digests agree).

A planner trial's whole output — the SSA pair sequence, the slice-leg
set, the costs it was scored with, and where it came from — is a few
hundred bytes of structure. Treating that structure as a first-class
*symbolic* value (the EinExprs view, arXiv:2403.18030: plans are
expressions, cheap to re-evaluate, compare and ship) is what lets the
planner fleet (:mod:`tnc_tpu_torch.serve.plansvc`) fan trials out across
replicas: results travel as plain JSON, duplicate candidates collapse
by a canonical digest, and two candidates diff *structurally* (shared
subtrees, slice-set delta) instead of by opaque repr comparison.

Discipline (shared with every on-disk artifact in this codebase):

- identity comes from :func:`tnc_tpu_torch.utils.digest.stable_digest` over
  the plan's *structure only* — the pairs and the sorted slice set.
  Costs and provenance are payload, not identity: two trials that land
  on the same tree+slicing dedupe even when their provenance differs;
- the wire form is plain JSON (never pickle) and self-verifying: the
  recorded digest is recomputed on :meth:`SymbolicPlan.from_obj`, so a
  corrupt or tampered result file degrades to "drop the trial", never
  to adopting a plan that isn't what its digest claims.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Mapping, Sequence

from tnc_tpu_torch.utils.digest import stable_digest

WIRE_VERSION = 1


def plan_digest(
    pairs: Sequence[Sequence[int]], slice_legs: Sequence[int]
) -> str:
    """Canonical structural identity of (tree, slice set) — the dedupe
    key for planner trials. Stable across processes and hash seeds
    (:func:`~tnc_tpu_torch.utils.digest.stable_digest`); slice legs are
    sorted so set order never splits identical plans.

    >>> a = plan_digest([(0, 1), (2, 3)], [7, 4])
    >>> a == plan_digest([[0, 1], [2, 3]], (4, 7))
    True
    >>> a == plan_digest([(0, 1), (2, 3)], [4])
    False
    """
    return stable_digest(
        "tnc-symplan-v%d" % WIRE_VERSION,
        tuple((int(a), int(b)) for a, b in pairs),
        tuple(sorted(int(l) for l in slice_legs)),
    )


@dataclass(frozen=True)
class SymbolicPlan:
    """One candidate contraction plan as a symbolic value.

    ``pairs`` are SSA pairs over the flat leaves (what
    :func:`~tnc_tpu_torch.contractionpath.sliced_cost.joint_slice_search`
    returns), ``slice_legs``/``slice_dims`` the slice set, ``cost`` the
    hoisted sliced cost in the trial's objective domain (flops, or
    predicted seconds under a calibrated model). ``provenance``
    records which trial produced it (kind, seed, SA settings) — it
    rides the wire but never enters the digest.

    >>> p = SymbolicPlan.from_search([(0, 1), (2, 3)], (4,), (2,), 96.0)
    >>> SymbolicPlan.from_obj(p.to_obj()) == p
    True
    """

    pairs: tuple[tuple[int, int], ...]
    slice_legs: tuple[int, ...]
    slice_dims: tuple[int, ...]
    cost: float
    sliced_total: float = 0.0
    peak: float = 0.0
    provenance: Mapping = field(default_factory=dict)

    @classmethod
    def from_search(
        cls,
        pairs: Sequence[Sequence[int]],
        slice_legs: Sequence[int],
        slice_dims: Sequence[int],
        cost: float,
        sliced_total: float = 0.0,
        peak: float = 0.0,
        provenance: Mapping | None = None,
    ) -> "SymbolicPlan":
        """Normalize raw search output (lists, unsorted slice sets)
        into the canonical frozen form: the slice set is co-sorted by
        leg so equal plans compare and digest equal."""
        order = sorted(
            range(len(slice_legs)), key=lambda i: int(slice_legs[i])
        )
        return cls(
            pairs=tuple((int(a), int(b)) for a, b in pairs),
            slice_legs=tuple(int(slice_legs[i]) for i in order),
            slice_dims=tuple(int(slice_dims[i]) for i in order),
            cost=float(cost),
            sliced_total=float(sliced_total),
            peak=float(peak),
            provenance=dict(provenance or {}),
        )

    def digest(self) -> str:
        return plan_digest(self.pairs, self.slice_legs)

    @property
    def num_slices(self) -> int:
        n = 1
        for d in self.slice_dims:
            n *= d
        return n

    def slicing(self):
        """The plan's slice set as a
        :class:`~tnc_tpu_torch.contractionpath.slicing.Slicing` (or None for
        an unsliced plan)."""
        if not self.slice_legs:
            return None
        from tnc_tpu_torch.contractionpath.slicing import Slicing

        return Slicing(self.slice_legs, self.slice_dims)

    # -- wire format --------------------------------------------------------

    def to_obj(self) -> dict:
        return {
            "version": WIRE_VERSION,
            "digest": self.digest(),
            "pairs": [[a, b] for a, b in self.pairs],
            "slice_legs": list(self.slice_legs),
            "slice_dims": list(self.slice_dims),
            "cost": self.cost,
            "sliced_total": self.sliced_total,
            "peak": self.peak,
            "provenance": dict(self.provenance),
        }

    @classmethod
    def from_obj(cls, obj: Mapping) -> "SymbolicPlan":
        """Inverse of :meth:`to_obj`; raises ``ValueError`` when the
        wire record is structurally unusable or its recorded digest
        does not match the recomputed one (corruption, tampering, or a
        version drift — the caller drops the trial)."""
        if not isinstance(obj, Mapping) or obj.get("version") != WIRE_VERSION:
            raise ValueError(f"unusable symbolic plan record: {obj!r:.80}")
        plan = cls.from_search(
            obj["pairs"],
            obj["slice_legs"],
            obj["slice_dims"],
            obj["cost"],
            obj.get("sliced_total", 0.0),
            obj.get("peak", 0.0),
            obj.get("provenance"),
        )
        if obj.get("digest") != plan.digest():
            raise ValueError(
                "symbolic plan digest mismatch: recorded "
                f"{obj.get('digest')!r} != recomputed {plan.digest()!r}"
            )
        return plan

    # -- structural comparison ---------------------------------------------

    def subtree_keys(self) -> frozenset[frozenset[int]]:
        """The leaf set under every internal node — the tree's
        structural fingerprint set. Two plans share a subtree exactly
        when they contract the same leaves together (regardless of SSA
        numbering), which is what :func:`diff` counts."""
        n = len(self.pairs) + 1  # SSA: leaves 0..n-1, internals n..2n-2
        below: dict[int, frozenset[int]] = {
            i: frozenset((i,)) for i in range(n)
        }
        keys = []
        nxt = n
        for a, b in self.pairs:
            below[nxt] = below[a] | below[b]
            keys.append(below[nxt])
            nxt += 1
        return frozenset(keys)


@dataclass(frozen=True)
class PlanDiff:
    """Structural delta between two symbolic plans: subtree overlap
    (by leaf sets, SSA-numbering independent) and the slice-set delta.

    >>> a = SymbolicPlan.from_search([(0, 1), (4, 2), (5, 3)], (7,), (2,), 1.0)
    >>> b = SymbolicPlan.from_search([(0, 1), (2, 3), (4, 5)], (9,), (2,), 1.0)
    >>> d = diff(a, b)
    >>> (d.shared_subtrees, d.only_a, d.only_b)
    (2, 1, 1)
    >>> (d.slices_added, d.slices_dropped, d.identical)
    ((9,), (7,), False)
    """

    shared_subtrees: int
    only_a: int
    only_b: int
    slices_added: tuple[int, ...]  # in b, not a
    slices_dropped: tuple[int, ...]  # in a, not b

    @property
    def identical(self) -> bool:
        return (
            self.only_a == 0
            and self.only_b == 0
            and not self.slices_added
            and not self.slices_dropped
        )


def diff(a: SymbolicPlan, b: SymbolicPlan) -> PlanDiff:
    """Structural diff of two candidates — what a coordinator logs when
    a merge replaces the incumbent (how different is the winner?), and
    what trial-diversity audits read instead of eyeballing pair lists."""
    ka, kb = a.subtree_keys(), b.subtree_keys()
    sa, sb = set(a.slice_legs), set(b.slice_legs)
    return PlanDiff(
        shared_subtrees=len(ka & kb),
        only_a=len(ka - kb),
        only_b=len(kb - ka),
        slices_added=tuple(sorted(sb - sa)),
        slices_dropped=tuple(sorted(sa - sb)),
    )
