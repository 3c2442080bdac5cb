"""The port's multi-device executors against the JAX package's on the CPU:
``tnc_tpu_torch.parallel`` (the partitioned executor with its scatter,
local phase, fan-in and global slicing, and the slice-parallel executor)
against ``tnc_tpu.parallel`` — the counterparts of
``tests/test_distributed.py`` and ``tests/test_partitioned_sliced.py``.

The reference runs on its 8 virtual CPU devices (``tests/conftest.py``),
the port on ``[torch.device("cpu")] * k``. Each case builds the network in
the reference and carries it over to the port as plain values (legs, bond
dims and numpy data), so both packages contract exactly the same tensors
along the same nested path. Results are held to the reference within
1e-10 relative in complex128 and 1e-5 in split (float32) mode; schedules,
mappings, slicings and span counters are equal.
"""

import logging
import os
import random
import sys

import numpy as np
import pytest
import torch

import tnc_tpu.obs as ref_obs
import tnc_tpu.parallel.partitioned as ref_part
import tnc_tpu.parallel.sliced_parallel as ref_spmd
import tnc_tpu_torch.obs as port_obs
import tnc_tpu_torch.parallel.partitioned as port_part
import tnc_tpu_torch.parallel.sliced_parallel as port_spmd
from tnc_tpu import CompositeTensor as RefComposite
from tnc_tpu.builders.connectivity import ConnectivityLayout
from tnc_tpu.builders.random_circuit import random_circuit
from tnc_tpu.contractionpath.contraction_path import ContractionPath as RefPath
from tnc_tpu.contractionpath.paths import Greedy, OptMethod
from tnc_tpu.contractionpath.repartitioning import compute_solution
from tnc_tpu.obs.core import MetricsRegistry as RefRegistry
from tnc_tpu.ops.sliced import SlicedProgram as RefSliced
from tnc_tpu.tensornetwork.contraction import contract_tensor_network
from tnc_tpu.tensornetwork.partitioning import find_partitioning, partition_tensor_network
from tnc_tpu.tensornetwork.simplify import simplify_network
from tnc_tpu_torch.contractionpath.contraction_path import ContractionPath
from tnc_tpu_torch.obs.core import MetricsRegistry
from tnc_tpu_torch.ops.sliced import SlicedProgram
from tnc_tpu_torch.tensornetwork.tensor import CompositeTensor, LeafTensor
from tnc_tpu_torch.tensornetwork.tensordata import TensorData

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _cluster_fixture import cluster_chain  # noqa: E402
from _torch_partition_cases import path_to_port, to_port  # noqa: E402

CPU = torch.device("cpu")


def cpus(k: int) -> list:
    return [CPU] * k


def value(leaf) -> complex:
    return complex(np.asarray(leaf.data.into_data()).reshape(-1)[0])


def close(got: complex, want: complex, rel: float) -> bool:
    return abs(got - want) <= rel * max(abs(want), 1e-300)


def _partitioned_network(k=4, qubits=8, depth=4, seed=7):
    """The reference test's network: a LINE random circuit, partitioned,
    ``Greedy`` over the partitions; with its port copies."""
    rng = np.random.default_rng(seed)
    tn = random_circuit(qubits, depth, 0.9, 0.8, rng, ConnectivityLayout.LINE)
    part = find_partitioning(tn, k)
    grouped = partition_tensor_network(RefComposite(list(tn.tensors)), part)
    path = Greedy(OptMethod.GREEDY).find_path(grouped).replace_path()
    return tn, grouped, path, to_port(grouped), path_to_port(path)


def _oracle(tn) -> complex:
    flat = Greedy(OptMethod.GREEDY).find_path(tn).replace_path()
    return value(contract_tensor_network(tn, flat))


# ---------------------------------------------------------------------------
# host rules: the survivor, the mapping, the shard map, the error


@pytest.mark.parametrize("k, toplevel", [
    (4, [(0, 1), (2, 3), (0, 2)]),
    (4, [(3, 1), (3, 0), (3, 2)]),
    (3, [(0, 1)]),                 # two survivors
    (3, [(0, 1), (2, 1)]),         # reuses a consumed index
    (8, [(0, 1), (2, 3), (4, 5), (6, 7), (0, 2), (4, 6), (0, 4)]),
])
def test_fanin_survivor(k, toplevel):
    try:
        want = ref_part._fanin_survivor(k, toplevel)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split(":")[0]):
            port_part._fanin_survivor(k, toplevel)
        return
    assert port_part._fanin_survivor(k, toplevel) == want
    assert (port_part.DeviceTensorMapping.for_path(k, toplevel).device_of_partition
            == ref_part.DeviceTensorMapping.for_path(k, toplevel).device_of_partition)


def test_device_mapping_pins_root_to_zero():
    mapping = port_part.DeviceTensorMapping.for_path(4, [(3, 1), (3, 0), (3, 2)])
    assert mapping.device(3) == 0
    assert sorted(mapping.device_of_partition) == [0, 1, 2, 3]


@pytest.mark.parametrize("k, toplevel, n_procs", [
    (4, [(3, 1), (3, 0), (3, 2)], 2),
    (4, [(0, 1), (2, 3), (0, 2)], 1),
    (8, [(0, 1), (2, 3), (4, 5), (6, 7), (0, 2), (4, 6), (0, 4)], 3),
    (5, [(4, 0), (4, 1), (2, 3), (4, 2)], 4),
    (1, [], 2),
])
def test_process_shard_map_pins_root_and_balances(k, toplevel, n_procs):
    owner = port_part.process_shard_map(k, toplevel, n_procs)
    assert owner == ref_part.process_shard_map(k, toplevel, n_procs)
    root = port_part._fanin_survivor(k, toplevel) if toplevel else 0
    assert owner[root] == 0
    counts = [owner.count(p) for p in range(n_procs)]
    assert max(counts) - min(counts) <= 1


def test_partition_error_names_process_device_and_phase():
    err = port_part.PartitionExecutionError(3, 2, RuntimeError("boom"), phase="fanin")
    ref = ref_part.PartitionExecutionError(3, 2, RuntimeError("boom"), phase="fanin")
    assert (err.partition, err.device, err.process, err.phase) == (3, 2, 0, "fanin")
    assert str(err) == str(ref)
    assert isinstance(err.original, RuntimeError)


def test_gather_and_broadcast_single_process_identity():
    assert port_part.gather_objects({"rows": [1, 2]}) == [{"rows": [1, 2]}]
    assert port_part.broadcast_object([1, "a"]) == [1, "a"]
    path = ContractionPath.simple([(0, 1)])
    assert port_part.broadcast_path(path) is path
    assert port_part.p2p_sequence() is None  # no process group: no store
    lost = port_part.GatherLost(1)
    assert repr(lost) == repr(ref_part.GatherLost(1)) == "GatherLost(process=1)"
    assert lost == port_part.GatherLost(1) and lost != port_part.GatherLost(0)


# ---------------------------------------------------------------------------
# the partitioned executor against the reference


def test_distributed_vs_single_process_oracle():
    tn, grouped, path, ptn, ppath = _partitioned_network(k=4)
    want = value(ref_part.distributed_partitioned_contraction(grouped, path,
                                                              dtype="complex128"))
    got_t = port_part.distributed_partitioned_contraction(ptn, ppath, devices=cpus(4),
                                                          dtype="complex128")
    assert close(value(got_t), want, 1e-10)
    assert close(value(got_t), _oracle(tn), 1e-10)


def test_distributed_result_on_device_zero():
    _, grouped, path, ptn, ppath = _partitioned_network(k=4, seed=11)
    import jax

    comm, buffers = ref_part.scatter_partitions(grouped, path, jax.devices(), "complex128",
                                                False)
    results = ref_part.local_contract_partitions(comm, buffers, False, None)
    want, want_meta = ref_part.intermediate_reduce(comm, path.toplevel, results, False, None)

    devices = cpus(4)
    comm, buffers = port_part.scatter_partitions(ptn, ppath, devices, "complex128", False)
    assert comm.mapping.device_of_partition == ref_part.DeviceTensorMapping.for_path(
        4, path.toplevel).device_of_partition
    results = port_part.local_contract_partitions(comm, buffers, False, None)
    final, meta = port_part.intermediate_reduce(comm, ppath.toplevel, results, False, None)
    assert final.device == devices[0]
    assert (meta.legs, meta.bond_dims) == (want_meta.legs, want_meta.bond_dims)
    np.testing.assert_allclose(final.numpy().reshape(-1), np.asarray(want).reshape(-1),
                               rtol=1e-10)


def test_distributed_split_complex_mode():
    """The split (real, imag) float32 path the card runs, on the CPU."""
    _, grouped, path, ptn, ppath = _partitioned_network(k=2, qubits=6, depth=3, seed=13)
    want = value(ref_part.distributed_partitioned_contraction(
        grouped, path, dtype="complex64", split_complex=True))
    got = value(port_part.distributed_partitioned_contraction(
        ptn, ppath, devices=cpus(2), dtype="complex64", split_complex=True))
    assert close(got, want, 1e-5)


def test_distributed_rejects_unpartitioned_network():
    rng = np.random.default_rng(3)
    tn = random_circuit(6, 3, 0.9, 0.8, rng, ConnectivityLayout.LINE)
    path = path_to_port(Greedy(OptMethod.GREEDY).find_path(tn).replace_path())
    with pytest.raises(TypeError):
        port_part.distributed_partitioned_contraction(to_port(tn), path, devices=cpus(8))


def test_distributed_rejects_too_few_devices():
    _, _, _, ptn, ppath = _partitioned_network(k=4)
    with pytest.raises(ValueError, match="devices"):
        port_part.distributed_partitioned_contraction(ptn, ppath, devices=cpus(2))
    with pytest.raises(ValueError, match="need 9 devices"):
        port_part.distributed_partitioned_contraction(ptn, ppath, devices=cpus(8),
                                                      n_devices=9)


@pytest.mark.parametrize("toplevel, levels", [
    ([(0, 1), (2, 3), (4, 5), (6, 7), (0, 2), (4, 6), (0, 4)], [4, 2, 1]),
    ([(0, 1), (0, 2), (0, 3)], [1, 1, 1]),
])
def test_fanin_levels_schedule(toplevel, levels):
    """The level schedule the executors walk is the reference's."""
    from tnc_tpu.contractionpath.communication_schemes import fanin_levels as ref_levels
    from tnc_tpu_torch.contractionpath.communication_schemes import fanin_levels

    got = fanin_levels(toplevel)
    assert got == ref_levels(toplevel)
    assert [len(level) for level in got] == levels


def _balanced_partitioned_network():
    tn, grouped, path, ptn, ppath = _partitioned_network(k=8, qubits=16, depth=4, seed=5)
    assert len(grouped) == 8
    balanced = [(0, 1), (2, 3), (4, 5), (6, 7), (0, 2), (4, 6), (0, 4)]
    return (tn, grouped, RefPath(dict(path.nested), balanced), ptn,
            ContractionPath(dict(ppath.nested), balanced))


def _spans(obs_module, registry, run):
    obs_module.configure(enabled=True, registry=registry)
    try:
        out = run()
        recs = obs_module.get_registry().span_records()
    finally:
        obs_module.configure(enabled=False, registry=type(registry)())
    return out, recs


def test_overlapped_fanin_level_spans_and_oracle():
    """One ``partitioned.fanin_level`` span per level (4+2+1 pairs in 3),
    each with the reference's bytes and flops, and the flat oracle's
    value."""
    tn, grouped, path, ptn, ppath = _balanced_partitioned_network()
    want, ref_recs = _spans(ref_obs, RefRegistry(), lambda: value(
        ref_part.distributed_partitioned_contraction(grouped, path, dtype="complex128")))
    got, recs = _spans(port_obs, MetricsRegistry(), lambda: value(
        port_part.distributed_partitioned_contraction(ptn, ppath, devices=cpus(8),
                                                      dtype="complex128")))
    assert close(got, want, 1e-10)
    assert close(got, _oracle(tn), 1e-10)

    def counters(records, name):
        return [{k: r.args[k] for k in ("pairs", "levels", "bytes", "flops") if k in r.args}
                for r in records if r.name == name]

    for name in ("partitioned.fanin", "partitioned.fanin_level"):
        assert counters(recs, name) == counters(ref_recs, name)
    fanin = counters(recs, "partitioned.fanin")
    assert fanin[0]["pairs"] == 7 and fanin[0]["levels"] == 3
    assert [r["pairs"] for r in counters(recs, "partitioned.fanin_level")] == [4, 2, 1]
    assert len([r for r in recs if r.name == "partitioned.local_partition"]) == 8


def test_reordered_levels_bit_identical_to_path_order():
    """A level schedule may reorder independent pairs; the tree, and so the
    bits, are unchanged."""
    _, grouped, path, ptn, ppath = _partitioned_network(k=4, seed=19)
    order = [(2, 3), (0, 1), (0, 2)]
    p = ContractionPath(dict(ppath.nested), order)
    a = port_part.distributed_partitioned_contraction(ptn, p, devices=cpus(4),
                                                      dtype="complex128")
    b = port_part.distributed_partitioned_contraction(ptn, p, devices=cpus(4),
                                                      dtype="complex128")
    assert np.array_equal(a.data.into_data(), b.data.into_data())
    devices = cpus(4)
    finals = []
    for levels in ([[(2, 3)], [(0, 1)], [(0, 2)]], [[(0, 1), (2, 3)], [(0, 2)]]):
        comm, buffers = port_part.scatter_partitions(ptn, p, devices, "complex128", False)
        results = port_part.local_contract_partitions(comm, buffers, False, None)
        finals.append(port_part.intermediate_reduce(comm, order, results, False, None,
                                                    levels=levels)[0])
    assert torch.equal(finals[0], finals[1])
    want = value(ref_part.distributed_partitioned_contraction(
        grouped, RefPath(dict(path.nested), order), dtype="complex128"))
    assert close(value(a), want, 1e-10)


def test_local_phase_failure_names_process():
    from tnc_tpu_torch.resilience import faultinject as fi

    _, _, _, ptn, ppath = _partitioned_network(k=2, qubits=6, depth=3, seed=13)
    with fi.faults("partition.local(partition=1)=fatal*1"):
        with pytest.raises(port_part.PartitionExecutionError) as exc_info:
            port_part.distributed_partitioned_contraction(ptn, ppath, devices=cpus(2),
                                                          dtype="complex128")
    assert exc_info.value.partition == 1
    assert exc_info.value.process == 0
    assert exc_info.value.phase == "local"
    assert "process 0" in str(exc_info.value)


def test_fanin_failure_names_partition_and_phase():
    """A pair that cannot run (a wrong-shaped held tensor) raises naming the
    fan-in phase and the receiving partition."""
    _, _, _, ptn, ppath = _partitioned_network(k=4, seed=29)
    comm, buffers = port_part.scatter_partitions(ptn, ppath, cpus(4), "complex128", False)
    results = port_part.local_contract_partitions(comm, buffers, False, None)
    x, y = ppath.toplevel[0]
    results[y] = torch.zeros(3, dtype=torch.complex128)
    with pytest.raises(port_part.PartitionExecutionError) as exc_info:
        port_part.intermediate_reduce(comm, ppath.toplevel, results, False, None,
                                      levels=[[pair] for pair in ppath.toplevel])
    assert exc_info.value.phase == "fanin"
    assert exc_info.value.partition == x


def test_process_sharded_single_process_bit_identical():
    """``process_sharded=True`` as one process walks the sharded code path
    (owner map, level fan-in, final broadcast) and gives the bits of the
    single-process executor."""
    _, _, _, ptn, ppath = _partitioned_network(k=4, seed=29)
    a = port_part.distributed_partitioned_contraction(ptn, ppath, devices=cpus(4),
                                                      dtype="complex128")
    b = port_part.distributed_partitioned_contraction(ptn, ppath, dtype="complex128",
                                                      process_sharded=True, device="cpu")
    assert np.array_equal(a.data.into_data(), b.data.into_data())


def test_process_sharded_rejects_explicit_placement():
    _, _, _, ptn, ppath = _partitioned_network(k=4, seed=29)
    with pytest.raises(ValueError, match="devices"):
        port_part.distributed_partitioned_contraction(
            ptn, ppath, dtype="complex128", process_sharded=True, devices=cpus(4))
    with pytest.raises(ValueError, match="devices"):
        port_part.distributed_partitioned_contraction(
            ptn, ppath, dtype="complex128", process_sharded=True, n_devices=1)


def test_default_devices_need_cuda():
    """``devices=None`` means every visible CUDA device; without CUDA it
    raises and never falls back to the host."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: None resolves to it")
    _, _, _, ptn, ppath = _partitioned_network(k=2, qubits=6, depth=3, seed=13)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_part.distributed_partitioned_contraction(ptn, ppath)


@pytest.fixture
def lane1(monkeypatch):
    """The reference's memory model without its TPU lane padding, the
    port's model (``ops/budget.padded_elems``), so both slice the same
    partitions under one budget."""
    import tnc_tpu.ops.budget as ref_budget

    monkeypatch.setattr(ref_budget, "_LANE", 1)


#: a budget under the cluster chain's partition peaks (12672 bytes)
CLUSTER_HBM = 1 << 13


def _cluster_case(k=2, m=6):
    ctn = cluster_chain(k=k, m=m, bond=2)
    grouped = partition_tensor_network(RefComposite(list(ctn.tensors)),
                                       find_partitioning(ctn, k))
    path = Greedy(OptMethod.GREEDY).find_path(grouped).replace_path()
    return ctn, grouped, path, to_port(grouped), path_to_port(path)


def test_mesh_sliced_strategy_psum_reduce(lane1):
    """``local_sliced_strategy="mesh"``: a budget-sliced partition's slices
    spread over its device and the spare ones, the partials summed on the
    partition's device."""
    ctn, grouped, path, ptn, ppath = _cluster_case()
    want = value(ref_part.distributed_partitioned_contraction(
        grouped, path, dtype="complex128", hbm_bytes=CLUSTER_HBM,
        local_sliced_strategy="mesh"))
    comm, _ = port_part.scatter_partitions(ptn, ppath, cpus(8), "complex128", False,
                                           hbm_bytes=CLUSTER_HBM)
    assert all(isinstance(p, SlicedProgram) for p in comm.programs)
    got = value(port_part.distributed_partitioned_contraction(
        ptn, ppath, devices=cpus(8), dtype="complex128", hbm_bytes=CLUSTER_HBM,
        local_sliced_strategy="mesh"))
    assert close(got, want, 1e-10)
    assert close(got, _oracle(ctn), 1e-10)


@pytest.mark.parametrize("strategy, hoist", [("chunked", False), ("chunked", True),
                                             ("loop", False), ("loop", True)])
def test_local_sliced_strategies_match_reference(lane1, strategy, hoist):
    import jax

    ctn, grouped, path, ptn, ppath = _cluster_case()
    ref_comm, _ = ref_part.scatter_partitions(grouped, path, jax.devices()[:2], "complex128",
                                              False, hbm_bytes=CLUSTER_HBM)
    comm, _ = port_part.scatter_partitions(ptn, ppath, cpus(2), "complex128", False,
                                           hbm_bytes=CLUSTER_HBM)
    assert _slicings(comm.programs) == _slicings(ref_comm.programs)
    assert all(isinstance(p, SlicedProgram) for p in comm.programs)
    want = value(ref_part.distributed_partitioned_contraction(
        grouped, path, dtype="complex128", hbm_bytes=CLUSTER_HBM,
        local_sliced_strategy=strategy, hoist=hoist))
    got = value(port_part.distributed_partitioned_contraction(
        ptn, ppath, devices=cpus(2), dtype="complex128", hbm_bytes=CLUSTER_HBM,
        local_sliced_strategy=strategy, hoist=hoist, slice_batch=4))
    assert close(got, want, 1e-10)
    assert close(got, _oracle(ctn), 1e-10)


def test_unknown_sliced_strategy_raises():
    _, _, _, ptn, ppath = _cluster_case()
    with pytest.raises(ValueError, match="sliced_strategy"):
        port_part.distributed_partitioned_contraction(
            ptn, ppath, devices=cpus(2), hbm_bytes=CLUSTER_HBM, local_sliced_strategy="scan")


def test_replan_fanin_matches_reference():
    """A latency-aware scheme re-derives the fan-in from the partitions'
    local costs, as the reference does (and its result is unchanged)."""
    from tnc_tpu.contractionpath.communication_schemes import (
        CommunicationScheme as RefScheme,
    )
    from tnc_tpu_torch.contractionpath.communication_schemes import CommunicationScheme

    _, grouped, path, ptn, ppath = _partitioned_network(k=4, seed=7)
    assert (port_part.partition_latency_map(ptn, ppath)
            == ref_part.partition_latency_map(grouped, path))
    got = port_part.replan_fanin(ptn, ppath, CommunicationScheme.WEIGHTED_BRANCH_BOUND,
                                 rng=random.Random(3))
    want = ref_part.replan_fanin(grouped, path, RefScheme.WEIGHTED_BRANCH_BOUND,
                                 rng=random.Random(3))
    assert [tuple(p) for p in got.toplevel] == [tuple(p) for p in want.toplevel]
    a = port_part.distributed_partitioned_contraction(
        ptn, ppath, devices=cpus(4), dtype="complex128",
        communication_scheme=CommunicationScheme.WEIGHTED_BRANCH_BOUND)
    assert close(value(a), value(ref_part.distributed_partitioned_contraction(
        grouped, path, dtype="complex128")), 1e-10)


# ---------------------------------------------------------------------------
# partitioning x slicing (BASELINE config #5)


@pytest.fixture(scope="module")
def partitioned_case():
    rng = np.random.default_rng(11)
    tn = simplify_network(random_circuit(24, 16, 0.4, 0.4, rng, ConnectivityLayout.LINE,
                                         bitstring="0" * 24))
    parts = find_partitioning(tn, 4)
    ptn, ppath, _, _ = compute_solution(tn, parts, rng=random.Random(5))
    flat = Greedy(OptMethod.GREEDY).find_path(tn)
    oracle = value(contract_tensor_network(tn, flat.replace_path(), backend="numpy"))
    return ptn, ppath, to_port(ptn), path_to_port(ppath), oracle


def _slicings(programs) -> list:
    return [(p.slicing.legs, p.slicing.dims) if isinstance(p, (SlicedProgram, RefSliced))
            else None for p in programs]


def test_budget_forces_partition_slicing(lane1):
    """Clusters with internal structure slice for real under a budget, the
    same partitions on the same legs as the reference's."""
    import jax

    tn = cluster_chain(k=4, m=7, bond=2, seed=0)
    ptn, ppath, _, _ = compute_solution(tn, find_partitioning(tn, 4), rng=random.Random(7))
    # under the partitions' modeled peaks (106944-115136 bytes)
    ref_comm, _ = ref_part.scatter_partitions(ptn, ppath, jax.devices()[:4], "complex64",
                                              False, hbm_bytes=1 << 16)
    comm, _ = port_part.scatter_partitions(to_port(ptn), path_to_port(ppath), cpus(4),
                                           "complex64", False, hbm_bytes=1 << 16)
    sliced = [p for p in comm.programs if isinstance(p, SlicedProgram)]
    assert sliced and all(p.slicing.num_slices > 1 for p in sliced)
    assert _slicings(comm.programs) == _slicings(ref_comm.programs)


def test_budget_on_boundary_bound_partition_runs_unsliced(lane1, partitioned_case, caplog):
    """A circuit partition whose peak is its own cut boundary has no
    sliceable closed legs: it runs unsliced and the warning names global
    slicing."""
    _, _, ptn, ppath, _ = partitioned_case
    with caplog.at_level(logging.WARNING, logger="tnc_tpu_torch.parallel.partitioned"):
        comm, _ = port_part.scatter_partitions(ptn, ppath, cpus(4), "complex64", False,
                                               hbm_bytes=1 << 12)
    for p in comm.programs:
        assert not (isinstance(p, SlicedProgram) and p.slicing.num_slices == 1)
    assert any("running unsliced" in rec.message and "global" in rec.message
               for rec in caplog.records), [rec.message for rec in caplog.records]


def test_partitioned_sliced_matches_oracle(lane1, partitioned_case):
    ref_ptn, ref_ppath, ptn, ppath, oracle = partitioned_case
    want = value(ref_part.distributed_partitioned_contraction(ref_ptn, ref_ppath,
                                                              n_devices=4,
                                                              hbm_bytes=2 << 20))
    got = value(port_part.distributed_partitioned_contraction(ptn, ppath, devices=cpus(4),
                                                              hbm_bytes=2 << 20))
    assert abs(got - oracle) <= 1e-5 * max(1.0, abs(oracle))
    assert abs(got - want) <= 1e-5 * max(1.0, abs(want))


def test_unbudgeted_path_unchanged(partitioned_case):
    _, _, ptn, ppath, _ = partitioned_case
    comm, _ = port_part.scatter_partitions(ptn, ppath, cpus(4), "complex64", False)
    assert not any(isinstance(p, SlicedProgram) for p in comm.programs)


@pytest.mark.parametrize("dtype, split, rel", [("complex64", False, 1e-5),
                                               ("complex64", True, 1e-5),
                                               ("complex128", False, 1e-10)])
def test_global_sliced_composition_matches_reference(partitioned_case, dtype, split, rel):
    """Global slicing across partitions (cut edges included): the
    reference's slicing, its value per slice prefix and in full."""
    ref_ptn, ref_ppath, ptn, ppath, oracle = partitioned_case
    out, slicing = port_part.distributed_partitioned_sliced_contraction(
        ptn, ppath, devices=cpus(4), dtype=dtype, split_complex=split, target_size=2**12)
    # the reference's native complex of the same width (its split mode on
    # the CPU runs Pallas in interpret mode, seconds a slice)
    ref_out, ref_slicing = ref_part.distributed_partitioned_sliced_contraction(
        ref_ptn, ref_ppath, n_devices=4, dtype=dtype, split_complex=False,
        target_size=2**12)
    assert slicing.num_slices > 1
    assert (slicing.legs, slicing.dims) == (ref_slicing.legs, ref_slicing.dims)
    assert close(value(out), value(ref_out), rel)
    assert abs(value(out) - oracle) <= 1e-5 * max(1.0, abs(oracle))


def test_partitioned_sliced_executor_prefix_sums(partitioned_case):
    """``run(n)`` sums the first n slices (the bench's warm-up and probe),
    as the reference's does, and reuses what it planned."""
    ref_ptn, ref_ppath, ptn, ppath, _ = partitioned_case
    run, slicing, meta = port_part.partitioned_sliced_executor(
        ptn, ppath, devices=cpus(4), dtype="complex128", target_size=2**12)
    ref_run, ref_slicing, ref_meta = ref_part.partitioned_sliced_executor(
        ref_ptn, ref_ppath, n_devices=4, dtype="complex128", target_size=2**12)
    assert (meta.legs, meta.bond_dims) == (ref_meta.legs, ref_meta.bond_dims)
    for n in (1, 2, slicing.num_slices):
        got, want = run(n), ref_run(n)
        assert got.shape == tuple(meta.bond_dims)
        assert close(complex(got.reshape(-1)[0]), complex(np.asarray(want).reshape(-1)[0]),
                     1e-10)


@pytest.mark.parametrize("cap", [None, 1 << 40])
def test_partitioned_sliced_executor_plans_with_its_cap(partitioned_case, monkeypatch, cap):
    """``plan_max_slices`` reaches ``plan_global_slicing`` as the
    reference's does (config #5's bench call passes the deep ranking cap,
    2^40); left out, the executable default 2^24."""
    ref_ptn, ref_ppath, ptn, ppath, _ = partitioned_case
    seen = {}
    for name, module in (("port", port_part), ("ref", ref_part)):
        real = module.plan_global_slicing

        def spy(*args, _real=real, _name=name, **kwargs):
            seen[_name] = kwargs.get("max_slices")
            return _real(*args, **kwargs)

        monkeypatch.setattr(module, "plan_global_slicing", spy)
    kw = {} if cap is None else {"plan_max_slices": cap}
    _, slicing, _ = port_part.partitioned_sliced_executor(
        ptn, ppath, devices=cpus(4), dtype="complex128", target_size=2**12, **kw)
    _, ref_slicing, _ = ref_part.partitioned_sliced_executor(
        ref_ptn, ref_ppath, n_devices=4, dtype="complex128", target_size=2**12, **kw)
    assert seen == {"port": cap or 1 << 24, "ref": cap or 1 << 24}
    assert (slicing.legs, slicing.dims) == (ref_slicing.legs, ref_slicing.dims)


def test_flatten_partitioned_path_is_valid():
    rng = np.random.default_rng(3)
    tn = simplify_network(random_circuit(12, 8, 0.4, 0.4, rng, ConnectivityLayout.LINE,
                                         bitstring="0" * 12))
    ptn, ppath, _, _ = compute_solution(tn, find_partitioning(tn, 3), rng=random.Random(1))
    leaves, pairs = port_part.flatten_partitioned_path(to_port(ptn), path_to_port(ppath))
    ref_leaves, ref_pairs = ref_part.flatten_partitioned_path(ptn, ppath)
    assert pairs == ref_pairs
    assert [(l.legs, l.bond_dims) for l in leaves] == [(l.legs, l.bond_dims)
                                                       for l in ref_leaves]
    alive = [True] * len(leaves)
    for x, y in pairs:
        assert alive[x] and alive[y]
        alive[y] = False
    assert sum(alive) == 1


@pytest.mark.parametrize("hbm, cap", [(16 << 30, 1 << 24), (1 << 10, 1 << 24),
                                      (1, 1 << 40)])
def test_plan_global_slicing_matches_reference(partitioned_case, hbm, cap):
    ref_ptn, ref_ppath, ptn, ppath, _ = partitioned_case
    assert port_part.global_slicing_target(hbm) == ref_part.global_slicing_target(hbm)
    leaves, pairs = port_part.flatten_partitioned_path(ptn, ppath)
    ref_leaves, ref_pairs = ref_part.flatten_partitioned_path(ref_ptn, ref_ppath)
    target = port_part.global_slicing_target(hbm)
    got = port_part.plan_global_slicing(leaves, pairs, target, max_slices=cap)
    want = ref_part.plan_global_slicing(ref_leaves, ref_pairs, target, max_slices=cap)
    assert (got.legs, got.dims) == (want.legs, want.dims)


# ---------------------------------------------------------------------------
# the slice-parallel executor


@pytest.fixture(scope="module")
def sliced_case():
    """A 12-qubit amplitude sliced into 8 slices, in both packages."""
    from tnc_tpu.contractionpath.slicing import find_parallel_slicing as ref_fps

    rng = np.random.default_rng(4)
    tn = simplify_network(random_circuit(12, 6, 0.5, 0.5, rng, ConnectivityLayout.SYCAMORE,
                                         bitstring="0" * 12))
    result = Greedy(OptMethod.GREEDY).find_path(tn)
    replace = result.replace_path()
    slicing = ref_fps(list(tn.tensors), replace.toplevel, 8, target_size=result.size / 4)
    assert slicing is not None and slicing.num_slices % 8 == 0
    return tn, replace, slicing


def _port_slicing(slicing):
    from tnc_tpu_torch.contractionpath.slicing import Slicing

    return Slicing(tuple(slicing.legs), tuple(slicing.dims))


@pytest.mark.parametrize("n, max_slices, hoist", [(1, None, False), (2, None, False),
                                                  (4, None, True), (8, None, False),
                                                  (4, 6, False)])
def test_distributed_sliced_matches_numpy_oracle(sliced_case, n, max_slices, hoist):
    """Each device's share summed and reduced: against the port's complex128
    host oracle over the same slices and against the reference's SPMD
    function on as many virtual devices."""
    from tnc_tpu_torch.ops.sliced import build_sliced_program, execute_sliced_numpy
    from tnc_tpu_torch.ops.program import flat_leaf_tensors

    tn, replace, slicing = sliced_case
    ptn, ppath, psl = to_port(tn), path_to_port(replace), _port_slicing(slicing)
    mesh = port_spmd.make_mesh(devices=cpus(n))
    got = port_spmd.distributed_sliced_contraction(ptn, ppath, psl, mesh=mesh,
                                                   dtype="complex128", max_slices=max_slices,
                                                   hoist=hoist)
    executed = port_spmd._effective_chunk(psl.num_slices, n, max_slices) * n
    sp = build_sliced_program(ptn, ppath, psl)
    arrays = [leaf.data.into_data() for leaf in flat_leaf_tensors(ptn)]
    oracle = execute_sliced_numpy(sp, arrays, max_slices=executed)
    assert close(value(got), complex(np.asarray(oracle).reshape(-1)[0]), 1e-10)
    want = ref_spmd.distributed_sliced_contraction(tn, replace, slicing, n_devices=n,
                                                   dtype="complex128",
                                                   max_slices=max_slices, hoist=hoist)
    assert close(value(got), value(want), 1e-10)
    assert (got.legs, got.bond_dims) == (list(want.legs), list(want.bond_dims))


def test_distributed_sliced_split_mode(sliced_case):
    tn, replace, slicing = sliced_case
    mesh = port_spmd.make_mesh(4, devices=cpus(8))
    assert mesh.shape == {"slices": 4}
    got = port_spmd.distributed_sliced_contraction(
        to_port(tn), path_to_port(replace), _port_slicing(slicing), mesh=mesh,
        split_complex=True)
    want = ref_spmd.distributed_sliced_contraction(tn, replace, slicing, n_devices=4,
                                                   split_complex=True)
    assert close(value(got), value(want), 1e-5)


def test_distributed_sliced_spans_and_rules(sliced_case):
    tn, replace, slicing = sliced_case
    ptn, ppath, psl = to_port(tn), path_to_port(replace), _port_slicing(slicing)
    with pytest.raises(ValueError, match="divisible"):
        port_spmd.distributed_sliced_contraction(ptn, ppath, psl,
                                                 mesh=port_spmd.make_mesh(devices=cpus(3)))
    with pytest.raises(ValueError, match="need 9 devices"):
        port_spmd.make_mesh(9, devices=cpus(8))
    _, ref_recs = _spans(ref_obs, RefRegistry(), lambda: ref_spmd.distributed_sliced_contraction(
        tn, replace, slicing, n_devices=4, dtype="complex128", hoist=True))
    _, recs = _spans(port_obs, MetricsRegistry(), lambda: port_spmd.distributed_sliced_contraction(
        ptn, ppath, psl, mesh=port_spmd.make_mesh(devices=cpus(4)), dtype="complex128",
        hoist=True))

    def spmd(records):
        return [{k: r.args[k] for k in ("slices", "devices", "hoisted", "flops")}
                for r in records if r.name == "spmd.contract"]

    assert spmd(recs) == spmd(ref_recs)


def test_spmd_dispatch_fault_retries():
    """A transient ``spmd.dispatch`` fault re-runs the dispatch (the inputs
    are not consumed) and a fatal one raises."""
    from tnc_tpu_torch.resilience import faultinject as fi
    from tnc_tpu_torch.resilience import retry as port_retry

    rng = np.random.default_rng(0)
    ts = [LeafTensor([0, 1], [4, 4], TensorData.matrix(rng.standard_normal((4, 4)))),
          LeafTensor([1, 2], [4, 4], TensorData.matrix(rng.standard_normal((4, 4)))),
          LeafTensor([2, 0], [4, 4], TensorData.matrix(rng.standard_normal((4, 4))))]
    from tnc_tpu_torch.contractionpath.slicing import find_slicing

    path = ContractionPath.simple([(0, 1), (0, 2)])
    slicing = find_slicing(ts, path.toplevel, target_size=12)
    mesh = port_spmd.make_mesh(devices=cpus(slicing.num_slices))
    tn = CompositeTensor([t.copy() for t in ts])
    clean = value(port_spmd.distributed_sliced_contraction(tn, path, slicing, mesh=mesh))
    previous = port_retry.default_policy()
    port_retry.configure_retry(port_retry.RetryPolicy(base_delay_s=0.0))
    try:
        with fi.faults("spmd.dispatch=transient*1"):
            again = value(port_spmd.distributed_sliced_contraction(tn, path, slicing,
                                                                   mesh=mesh))
        with fi.faults("spmd.dispatch=fatal*1"), pytest.raises(Exception):
            port_spmd.distributed_sliced_contraction(tn, path, slicing, mesh=mesh)
    finally:
        port_retry.configure_retry(previous)
    assert again == clean


@pytest.mark.parametrize("module", ["__init__", "partitioned", "sliced_parallel"])
def test_parallel_modules_import_no_jax_and_no_reference(module):
    """The package imports torch and the port only: no ``jax`` and nothing of
    ``tnc_tpu``, at module level or inside a function."""
    import ast
    import pathlib

    path = pathlib.Path(port_part.__file__).parent / f"{module}.py"
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    roots = {name.split(".")[0] for name in names}
    assert "jax" not in roots and "tnc_tpu" not in roots, sorted(roots)
    assert "tnc_tpu_torch" in roots
