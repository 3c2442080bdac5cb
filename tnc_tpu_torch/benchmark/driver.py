"""Sweep / Run phases of the benchmark CLI (the port's copy of
``tnc_tpu.benchmark.driver``).

:func:`do_sweep` plans one scenario on the host (no torch), caches the
artifact and appends its :class:`~tnc_tpu_torch.benchmark.results.
OptimizationResult`; :func:`do_run` loads it and contracts it with
``contract_tensor_network(tn, path, backend=...)`` — ``"torch"`` (the
default) is :class:`~tnc_tpu_torch.ops.backends.TorchBackend` on the card,
whose default policy sends chains through the ``fused_chain`` kernel, or
on the host under ``TNC_TPU_PLATFORM=cpu``; ``"numpy"`` the complex128
host oracle — or, with ``distributed``, through
:func:`~tnc_tpu_torch.parallel.distributed_partitioned_contraction` with
one device slot a partition (:func:`~tnc_tpu_torch.parallel._devices.
device_slots`: one card runs every partition on ``cuda:0``).
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass

from tnc_tpu_torch.benchmark.cache import ArtifactCache, cache_key
from tnc_tpu_torch.benchmark.methods import METHODS, MethodContext
from tnc_tpu_torch.benchmark.protocol import Protocol
from tnc_tpu_torch.benchmark.results import (
    OptimizationResult,
    ResultWriter,
    RunResult,
)
from tnc_tpu_torch.contractionpath.communication_schemes import CommunicationScheme
from tnc_tpu_torch.contractionpath.contraction_cost import (
    communication_path_op_costs,
    compute_memory_requirements,
    contract_path_cost,
    contract_size_tensors_bytes,
)
from tnc_tpu_torch.contractionpath.paths import Greedy, OptMethod
from tnc_tpu_torch.tensornetwork.contraction import contract_tensor_network
from tnc_tpu_torch.tensornetwork.tensor import CompositeTensor

log = logging.getLogger("tnc_tpu_torch.benchmark")


@dataclass
class Scenario:
    """One (circuit, partitions, seed, method) cell of a sweep."""

    circuit_name: str
    circuit_text: str  # QASM source (hashed into the cache key)
    partitions: int
    seed: int
    method: str
    scheme: str = "greedy"

    @property
    def run_id(self) -> str:
        return (
            f"{self.method}_{self.circuit_name}_p{self.partitions}"
            f"_s{self.seed}"
        )

    def key(self) -> str:
        return cache_key(
            self.scheme, self.circuit_text, self.seed, self.partitions,
            self.method,
        )


def _serial_cost(tn: CompositeTensor) -> tuple[float, float]:
    """Greedy single-device baseline."""
    result = Greedy(OptMethod.GREEDY).find_path(tn)
    return result.flops, result.size


def do_sweep(
    scenario: Scenario,
    tn: CompositeTensor,
    cache: ArtifactCache,
    writer: ResultWriter,
    protocol: Protocol,
    time_budget: float = 600.0,
) -> OptimizationResult | None:
    """Optimize one scenario, cache the artifact, append the record.

    >>> import tempfile, os, numpy as np
    >>> from tnc_tpu_torch.builders.connectivity import ConnectivityLayout
    >>> from tnc_tpu_torch.builders.random_circuit import random_circuit
    >>> d = tempfile.mkdtemp()
    >>> tn = random_circuit(6, 4, 0.5, 0.5, np.random.default_rng(0),
    ...                     ConnectivityLayout.LINE)
    >>> sc = Scenario("toy", "toy-circuit", 2, 1, "greedy")
    >>> r = do_sweep(sc, tn, ArtifactCache(os.path.join(d, "cache")),
    ...     ResultWriter(os.path.join(d, "r.jsonl")),
    ...     Protocol(os.path.join(d, "p.jsonl")), time_budget=5.0)
    >>> r.method, r.flops > 0
    ('greedy', True)
    >>> do_sweep(sc, tn, ArtifactCache(os.path.join(d, "cache")),
    ...     ResultWriter(os.path.join(d, "r.jsonl")),
    ...     Protocol(os.path.join(d, "p.jsonl")), time_budget=5.0) is None
    True

    Returns None when the protocol says this cell already ran (or
    crashed last time) — the crash-resume behavior.
    """
    run_id = "sweep/" + scenario.run_id
    if not protocol.should_run(run_id):
        log.info("skipping %s (already done or failed)", run_id)
        return None
    protocol.trying(run_id)

    method = METHODS[scenario.method]
    serial_flops, serial_memory = _serial_cost(tn)

    ctx = MethodContext(
        tn=tn,
        partitions=scenario.partitions,
        seed=scenario.seed,
        time_budget=time_budget,
        communication_scheme=CommunicationScheme.GREEDY,
    )
    t0 = time.monotonic()
    out_tn, out_path = method.run(ctx)
    optimization_time = time.monotonic() - t0

    # characterize: critical-path + sum cost, memory
    if out_path.nested:
        latency = {}
        for i, local in out_path.nested.items():
            cost, _ = contract_path_cost(out_tn[i].tensors, local, True)
            latency[i] = cost
        externals = [child.external_tensor() for child in out_tn.tensors]
        costs = [latency.get(i, 0.0) for i in range(len(externals))]
        (flops, flops_sum), _ = communication_path_op_costs(
            externals, out_path.toplevel, True, costs
        )
    else:
        flops, _ = contract_path_cost(out_tn.tensors, out_path, True)
        flops_sum = flops
    memory = compute_memory_requirements(
        out_tn.tensors, out_path, contract_size_tensors_bytes
    )

    cache.store(scenario.key(), out_tn, out_path)
    record = OptimizationResult(
        id=run_id,
        method=scenario.method,
        circuit=scenario.circuit_name,
        partitions=scenario.partitions,
        seed=scenario.seed,
        serial_flops=serial_flops,
        serial_memory=serial_memory,
        flops=flops,
        flops_sum=flops_sum,
        memory=memory,
        optimization_time=optimization_time,
    )
    writer.write(record)
    protocol.done(run_id)
    log.info(
        "sweep %s: flops %.3g (serial %.3g), %.1fs",
        run_id, flops, serial_flops, optimization_time,
    )
    return record


def do_run(
    scenario: Scenario,
    cache: ArtifactCache,
    writer: ResultWriter,
    protocol: Protocol,
    backend: str = "torch",
    distributed: bool = False,
    repeats: int = 1,
    checkpoint_dir=None,
) -> RunResult | None:
    """Contract a cached artifact, timing only the contraction (host
    leaves to host result, so the card's work is finished when a time is
    taken).

    >>> import tempfile, os, numpy as np
    >>> from tnc_tpu_torch.builders.connectivity import ConnectivityLayout
    >>> from tnc_tpu_torch.builders.random_circuit import random_circuit
    >>> d = tempfile.mkdtemp()
    >>> tn = random_circuit(6, 4, 0.5, 0.5, np.random.default_rng(0),
    ...                     ConnectivityLayout.LINE)
    >>> sc = Scenario("toy", "toy-circuit", 2, 1, "greedy")
    >>> cache = ArtifactCache(os.path.join(d, "cache"))
    >>> writer = ResultWriter(os.path.join(d, "r.jsonl"))
    >>> proto = Protocol(os.path.join(d, "p.jsonl"))
    >>> _ = do_sweep(sc, tn, cache, writer, proto)
    >>> r = do_run(sc, cache, writer, proto, backend="numpy")
    >>> r.id, r.time_to_solution > 0
    ('run-numpy/greedy_toy_p2_s1', True)

    With ``checkpoint_dir``, the cell runs under a per-cell
    ``TNC_TPU_CKPT`` (``tnc_tpu_torch.resilience.checkpoint``): a crash
    mid-slice-range leaves a checkpoint, the protocol requeues the cell
    on restart, and the rerun resumes from the persisted cursor."""
    import contextlib
    import os

    run_id = f"run-{backend}/" + scenario.run_id
    if not protocol.should_run(run_id):
        log.info("skipping %s (already done or failed)", run_id)
        return None
    # a requeued cell resumes mid-range: its wall time is NOT a full
    # contraction time and the record must say so
    resumed = run_id in protocol.resumable
    loaded = cache.load(scenario.key())
    if loaded is None:
        raise FileNotFoundError(
            f"no cached artifact for {scenario.key()}; run the sweep first"
        )
    protocol.trying(run_id)
    tn, path = loaded

    @contextlib.contextmanager
    def _cell_ckpt_env():
        if checkpoint_dir is None:
            yield
            return
        from tnc_tpu_torch.benchmark.protocol import cell_checkpoint_dir

        cell = cell_checkpoint_dir(checkpoint_dir, run_id)
        prev = os.environ.get("TNC_TPU_CKPT")
        os.environ["TNC_TPU_CKPT"] = str(cell)
        try:
            yield
        finally:
            if prev is None:
                os.environ.pop("TNC_TPU_CKPT", None)
            else:
                os.environ["TNC_TPU_CKPT"] = prev

    times = []
    with _cell_ckpt_env():
        for _ in range(max(1, repeats)):
            t0 = time.monotonic()
            if distributed and path.nested:
                from tnc_tpu_torch.obs.core import process_identity
                from tnc_tpu_torch.parallel import (
                    distributed_partitioned_contraction,
                )
                from tnc_tpu_torch.parallel._devices import device_slots

                # one device slot a partition, the visible devices in turn;
                # a group of several ranks shards the partitions itself
                devices = None if process_identity()[0] > 1 else device_slots(len(tn.tensors))
                distributed_partitioned_contraction(tn, path, devices=devices)
            else:
                contract_tensor_network(tn, path, backend=backend)
            times.append(time.monotonic() - t0)

    record = RunResult(
        id=run_id,
        method=scenario.method,
        circuit=scenario.circuit_name,
        partitions=scenario.partitions,
        seed=scenario.seed,
        time_to_solution=min(times),
        backend=backend,
        resumed=resumed,
    )
    writer.write(record)
    protocol.done(run_id)
    log.info("run %s: %.4fs", run_id, record.time_to_solution)
    return record
