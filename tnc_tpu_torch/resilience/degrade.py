"""OOM-adaptive degradation ladder for sliced execution (the port's copy of
``tnc_tpu.resilience.degrade``).

When the runtime throws ``RESOURCE_EXHAUSTED`` (on the card a
``torch.cuda.OutOfMemoryError``), retrying the identical
program fails identically — the program has to shrink. The ladder, from
cheapest to most invasive:

1. **Smaller slice batch** — handled *inside* the chunked executor
   (:mod:`tnc_tpu_torch.ops.chunked`): the per-device slice batch halves
   (replanning only the chunk plan, its CUDA graphs and their pool
   released first) and the run continues from the current cursor, down
   to batch 1.
2. **Finer slicing** — handled here: re-plan through the existing
   planner hook (:func:`~tnc_tpu_torch.contractionpath.slicing.slice_and_reconfigure`)
   at a 4× smaller element target, rebuild the sliced program, re-run.
3. **Chunked host-loop fallback** — if the backend was using the
   single-dispatch on-device loop (``sliced_strategy="loop"``), fall
   back to the chunked host-loop executor at batch 1, the
   smallest-footprint executor in the stack.

Every rung is visible through obs (``resilience.ladder.*`` counters and
gauges, plus the warning log), so a production run that survived an OOM
says exactly how much performance it paid.

On the card a failed attempt leaves what it held in the caching
allocator: the placed leaves, its slice's intermediates, a loop's captured
graph and its pool, all reachable from the exception's traceback. Before
the next rung runs, the ladder clears those frames, collects, and empties
the allocator's cache (:func:`release_failed_attempt`), as the chunked
executor's own OOM rung does; so the smaller program starts from what the
caller held before the call.
"""

from __future__ import annotations

import gc
import logging
import traceback

import numpy as np

from tnc_tpu_torch import obs
from tnc_tpu_torch.resilience.retry import FailureClass, classify_exception

logger = logging.getLogger(__name__)


def execute_sliced_resilient(
    tn,
    contract_path,
    slicing,
    arrays=None,
    backend=None,
    max_replans: int = 2,
    max_slices: int | None = None,
    host: bool = True,
):
    """Run a sliced contraction, walking the degradation ladder on
    RESOURCE_EXHAUSTED instead of crashing.

    ``tn`` + flat ``contract_path`` + initial ``slicing`` describe the
    network exactly as :func:`~tnc_tpu_torch.ops.sliced.build_sliced_program`
    consumes them (the network-level inputs are required because rung 2
    re-plans the slicing). Returns ``(result, slicing_used)`` — the
    slicing may be finer than requested after degradation.

    Transient failures are retried at the dispatch boundaries below this
    level; FATAL errors re-raise untouched.

    >>> import numpy as np
    >>> from tnc_tpu_torch.contractionpath.contraction_path import ContractionPath
    >>> from tnc_tpu_torch.contractionpath.slicing import Slicing
    >>> from tnc_tpu_torch.ops.backends import NumpyBackend
    >>> from tnc_tpu_torch.tensornetwork.tensor import CompositeTensor, LeafTensor
    >>> from tnc_tpu_torch.tensornetwork.tensordata import TensorData
    >>> rng = np.random.default_rng(0)
    >>> def mk(legs):
    ...     return LeafTensor(legs, [2] * len(legs),
    ...         TensorData.matrix(rng.standard_normal([2] * len(legs))))
    >>> tn = CompositeTensor([mk([0, 1]), mk([1, 2]), mk([2, 0])])
    >>> path = ContractionPath.simple([(0, 1), (0, 2)])
    >>> out, used = execute_sliced_resilient(
    ...     tn, path, Slicing((2,), (2,)), backend=NumpyBackend())
    >>> used.num_slices, out.shape
    (2, ())
    """
    from tnc_tpu_torch.contractionpath.contraction_path import (
        ContractionPath,
        replace_ssa_ordering,
    )
    from tnc_tpu_torch.contractionpath.slicing import slice_and_reconfigure
    from tnc_tpu_torch.ops.backends import TorchBackend
    from tnc_tpu_torch.ops.budget import program_peak_bytes
    from tnc_tpu_torch.ops.program import flat_leaf_tensors
    from tnc_tpu_torch.ops.sliced import build_sliced_program

    if contract_path.nested:
        raise ValueError(
            "execute_sliced_resilient expects a flat path; the partitioned "
            "executors carry their own per-partition recovery"
        )
    if backend is None:
        backend = TorchBackend()
    leaves = flat_leaf_tensors(tn)
    if arrays is None:
        arrays = [np.asarray(l.data.into_data()) for l in leaves]

    sp = build_sliced_program(tn, contract_path, slicing)
    ssa = replace_ssa_ordering(list(contract_path.toplevel), len(leaves))
    target: float | None = None
    replans = 0
    with obs.span("resilience.ladder") as osp:
        while True:
            try:
                out = backend.execute_sliced(
                    sp, arrays, max_slices=max_slices, host=host
                )
                osp.set(replans=replans, slices=sp.slicing.num_slices)
                return out, sp.slicing
            except Exception as exc:  # noqa: BLE001 — classified below
                if classify_exception(exc) is not FailureClass.RESOURCE:
                    raise
                fallback = replans >= max_replans
                if fallback and getattr(backend, "sliced_strategy", None) != "loop":
                    raise
                failure = f"{type(exc).__name__}: {exc}"
                _clear_frames(exc)
            # outside the handler: the exception and its frames are gone
            release_failed_attempt(backend)
            if fallback:
                # final rung: chunked host loop, batch 1 — the
                # smallest-footprint executor available
                logger.warning(
                    "degradation ladder: falling back to the "
                    "chunked host-loop executor at batch 1 (%s)", failure
                )
                obs.counter_add("resilience.ladder.fallback_chunked")
                fb = TorchBackend(
                    dtype=backend.dtype,
                    device=backend.device,
                    split_complex=backend.split_complex,
                    precision=backend.precision,
                    sliced_strategy="chunked",
                    slice_batch=1,
                    chunk_steps=backend.chunk_steps,
                    hoist=backend.hoist,
                )
                out = fb.execute_sliced(
                    sp, arrays, max_slices=max_slices, host=host
                )
                osp.set(replans=replans, fallback="chunked")
                return out, sp.slicing
            # rung 2: re-slice finer through the planner hook
            replans += 1
            if target is None:
                est = program_peak_bytes(sp.program)
                target = 2.0 ** np.floor(
                    np.log2(max(est.peak_bytes / 8.0 / 4.0, 4.0))
                )
            else:
                target = max(target / 4.0, 4.0)
            obs.counter_add("resilience.ladder.replans")
            logger.warning(
                "degradation ladder: RESOURCE_EXHAUSTED (%s); "
                "re-slicing finer at target %g elements (replan %d/%d)",
                failure, target, replans, max_replans,
            )
            pairs, new_slicing = slice_and_reconfigure(
                leaves, ssa, target,
                reconf_rounds=1, step_budget=None,
                final_rounds=2, final_budget=None,
            )
            if not new_slicing.legs:
                # target still above the peak: push it down and retry
                target = max(target / 4.0, 4.0)
                pairs, new_slicing = slice_and_reconfigure(
                    leaves, ssa, target,
                    reconf_rounds=1, step_budget=None,
                    final_rounds=2, final_budget=None,
                )
            sp = build_sliced_program(
                tn, ContractionPath.simple(pairs), new_slicing
            )
            obs.gauge_set(
                "resilience.ladder.num_slices", new_slicing.num_slices
            )


def _clear_frames(exc: BaseException) -> None:
    """Drop the locals of every finished frame an exception (and its
    cause or context chain) still references: the failed attempt's
    tensors, graphs and pools live there."""
    seen: set[int] = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        traceback.clear_frames(exc.__traceback__)
        exc = exc.__cause__ or exc.__context__


def release_failed_attempt(backend) -> None:
    """Return a failed attempt's device memory before the next rung runs:
    collect what its cleared frames left unreachable (graphs and pools
    among them), then, on a CUDA backend, empty the caching allocator's
    cache. A no-op on the host but for the collection."""
    gc.collect()
    device = getattr(backend, "device", None)
    if getattr(device, "type", None) == "cuda":
        import torch

        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
