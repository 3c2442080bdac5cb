"""The north-star plan in the port: one Sycamore single amplitude planned
the way the reference's ``bench_sycamore_amplitude`` plans BASELINE
config #3 (``bench.py:342-430``).

:func:`plan_northstar` builds ``sycamore_circuit(qubits, depth,
default_rng(seed))`` closed on the all-zeros bitstring, simplifies it,
finds the path with :class:`~tnc_tpu_torch.contractionpath.paths.hyper.
Hyperoptimizer` (``ntrials`` trials, the slicing target as its
``target_size``) and slices it with :func:`~tnc_tpu_torch.contractionpath.
slicing.slice_and_reconfigure` — both with the reference's defaults,
including their wall-clock budgets, so the plan depends on the host's
speed. The result feeds ``build_sliced_program`` /
``contract_tensor_network_sliced`` as it is.

The plan can be kept on disk as plain JSON (the replace pairs, the sliced
legs and dims, and the plan record) under ``.cache/northstar/`` at the
repository root; the reference's cache pickles its own objects, which the
port cannot load. The key (:func:`northstar_plan_key`) names the same
parameters as the reference's ``northstar_plan_key``.

This module is host code: it imports no ``torch``.
"""

from __future__ import annotations

import hashlib
import json
import os
import pickle
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from tnc_tpu_torch.contractionpath.contraction_path import ContractionPath
from tnc_tpu_torch.contractionpath.slicing import Slicing
from tnc_tpu_torch.tensornetwork.tensor import CompositeTensor

#: bump when a planner change invalidates kept plans
PLAN_SCHEME = "northstar-plan-v2-json"

#: the north star's parameters: (qubits, depth, rng seed, trials, log2 target)
NORTHSTAR = (53, 14, 42, 128, 29.0)


@dataclass
class NorthstarPlan:
    """A planned amplitude: the simplified network, its flat replace path,
    its slicing, and the plan record (numbers, seconds, which engines
    ran)."""

    tn: CompositeTensor
    path: ContractionPath
    slicing: Slicing
    record: dict


def northstar_plan_key(
    qubits: int, depth: int, seed: int, ntrials: int, target_log2: float
) -> str:
    """Stable name of a kept plan.

    >>> northstar_plan_key(53, 14, 42, 128, 29.0)
    'northstar-plan-v2-json_sycamore-53-m14-seed42-trials128_hyper-target2^29'
    """
    return (
        f"{PLAN_SCHEME}_sycamore-{qubits}-m{depth}-seed{seed}-trials{ntrials}"
        f"_hyper-target2^{target_log2:g}"
    )


def oracle_key(plan_key: str) -> str:
    """The key of the oracle artifacts computed from the plan kept under
    ``plan_key``.

    >>> oracle_key(northstar_plan_key(53, 14, 42, 128, 29.0))
    'northstar-oracle-v2-json_sycamore-53-m14-seed42-trials128_hyper-target2^29'
    """
    return plan_key.replace("northstar-plan", "northstar-oracle")


def plan_fingerprint(sp) -> str:
    """Content fingerprint of a sliced plan (the compiled program and
    slicing signature of a :class:`~tnc_tpu_torch.ops.sliced.SlicedProgram`):
    oracle artifacts are valid only for the exact plan they were computed
    from. The digest pickles the port's own signature objects, so it names
    a plan within this package."""
    return hashlib.sha256(pickle.dumps((sp.signature(),))).hexdigest()[:16]


def default_cache_dir() -> Path:
    """``.cache/northstar/`` at the repository root (git-ignored)."""
    return Path(__file__).resolve().parents[2] / ".cache" / "northstar"


def northstar_network(qubits: int, depth: int, seed: int) -> tuple[CompositeTensor, int]:
    """The simplified amplitude network and the raw network's tensor count."""
    from tnc_tpu_torch.builders.sycamore_circuit import sycamore_circuit
    from tnc_tpu_torch.tensornetwork.simplify import simplify_network

    raw, _ = sycamore_circuit(
        qubits, depth, np.random.default_rng(seed)
    ).into_amplitude_network("0" * qubits)
    return simplify_network(raw), len(raw.tensors)


def plan_numbers(inputs, replace: list[tuple[int, int]], slicing: Slicing) -> dict:
    """The sliced plan's cost numbers: slices, legs, the replayed per-slice
    peak, the sliced total and its hoisted split."""
    from tnc_tpu_torch.contractionpath.slicing import (
        hoisted_sliced_flops,
        sliced_flops,
        sliced_peak,
    )

    invariant, residual, hoisted = hoisted_sliced_flops(inputs, replace, slicing)
    return {
        "slices": slicing.num_slices,
        "sliced_legs": list(slicing.legs),
        "sliced_dims": list(slicing.dims),
        "steps": len(replace),
        "slice_peak": sliced_peak(inputs, replace, slicing),
        "sliced_total_flops": sliced_flops(inputs, replace, slicing),
        "invariant_flops": invariant,
        "residual_flops": residual,
        "hoisted_total_flops": hoisted,
    }


def plan_northstar(
    qubits: int = NORTHSTAR[0],
    depth: int = NORTHSTAR[1],
    seed: int = NORTHSTAR[2],
    ntrials: int = NORTHSTAR[3],
    target_log2: float = NORTHSTAR[4],
    *,
    cache: bool = False,
    cache_dir: str | Path | None = None,
    hyper_options: dict | None = None,
    slice_options: dict | None = None,
) -> NorthstarPlan:
    """Plan one Sycamore amplitude as the reference's north-star bench does.

    ``hyper_options`` and ``slice_options`` override the
    ``Hyperoptimizer`` and ``slice_and_reconfigure`` defaults (the tests
    turn the wall-clock budgets off with them). With ``cache`` the plan is
    read from, or else written to, ``cache_dir`` (default
    :func:`default_cache_dir`); a kept plan is used only if it was made
    with the same options.
    """
    from tnc_tpu_torch.contractionpath.paths import hyper
    from tnc_tpu_torch.contractionpath.slicing import slice_and_reconfigure
    from tnc_tpu_torch.partitioning import native_binding

    t0 = time.perf_counter()
    tn, raw_tensors = northstar_network(qubits, depth, seed)
    inputs = list(tn.tensors)
    target = 2.0**target_log2
    options = {"hyper": dict(hyper_options or {}), "slice": dict(slice_options or {})}
    key = northstar_plan_key(qubits, depth, seed, ntrials, target_log2)
    file = Path(cache_dir or default_cache_dir()) / f"{key}.json"
    if cache:
        kept = load_plan(file, tn, options)
        if kept is not None:
            kept.record["plan_s"] = time.perf_counter() - t0
            return kept

    t1 = time.perf_counter()
    finder = hyper.Hyperoptimizer(
        ntrials=ntrials, seed=seed, target_size=target, **options["hyper"]
    )
    result = finder.find_path(tn)
    hyper_s = time.perf_counter() - t1
    t2 = time.perf_counter()
    replace, slicing = slice_and_reconfigure(
        inputs, result.ssa_path.toplevel, target, **options["slice"]
    )
    slice_s = time.perf_counter() - t2
    record = {
        "config": [qubits, depth, seed, ntrials, target_log2],
        "tensors_raw": raw_tensors,
        "tensors": len(inputs),
        "path_flops": result.flops,
        "path_peak": result.size,
        **plan_numbers(inputs, replace, slicing),
        "hyper_s": hyper_s,
        "slice_s": slice_s,
        "plan_s": time.perf_counter() - t0,
        "native": native_binding.NATIVE,
        "trials": finder.last_trials,
        "cpu_count": os.cpu_count(),
        "options": options,
        "cached": False,
    }
    plan = NorthstarPlan(tn, ContractionPath.simple(replace), slicing, record)
    if cache:
        save_plan(file, plan)
    return plan


def save_plan(file: str | Path, plan: NorthstarPlan) -> None:
    """Write ``plan`` as plain JSON (atomically)."""
    file = Path(file)
    file.parent.mkdir(parents=True, exist_ok=True)
    blob = {
        "scheme": PLAN_SCHEME,
        "replace": plan.path.toplevel,
        "slicing": plan.slicing.to_obj(),
        "record": plan.record,
    }
    tmp = file.with_suffix(f".{os.getpid()}.tmp")
    tmp.write_text(json.dumps(blob))
    os.replace(tmp, file)


def load_plan(
    file: str | Path, tn: CompositeTensor, options: dict | None = None
) -> NorthstarPlan | None:
    """The plan kept in ``file`` for network ``tn``, or None when there is
    none, it belongs to another scheme or other options, or its path does
    not contract ``tn``."""
    file = Path(file)
    if not file.exists():
        return None
    blob = json.loads(file.read_text())
    record = blob["record"]
    if blob.get("scheme") != PLAN_SCHEME or (
        options is not None and record.get("options") != options
    ):
        return None
    replace = [(int(i), int(j)) for i, j in blob["replace"]]
    alive = set(range(len(tn.tensors)))
    for i, j in replace:
        if i not in alive or j not in alive or i == j:
            return None
        alive.discard(j)
    if len(alive) != 1:
        return None
    record["cached"] = True
    return NorthstarPlan(
        tn, ContractionPath.simple(replace), Slicing.from_obj(blob["slicing"]), record
    )
