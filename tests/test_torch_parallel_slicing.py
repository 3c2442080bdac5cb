"""The port's ``find_parallel_slicing`` and slice-parallel planning against
the JAX package's on the CPU (the counterparts of
``tests/test_parallel_slicing.py``): device-divisible slice sets equal to
the reference's for the same network and path, the memory slicing they
extend, the flop-minimizing extra legs, the plan-ranking gate of the
composed pipeline, the planner span, and the slice-parallel executor's
cache of device functions."""

import random as pyrandom

import numpy as np
import pytest
import torch

import tnc_tpu.contractionpath.slicing as ref_slicing
import tnc_tpu_torch.contractionpath.slicing as port_slicing
from _torch_partition_cases import MODEL, path_to_port, to_port
from tnc_tpu.builders.connectivity import ConnectivityLayout
from tnc_tpu.builders.random_circuit import random_circuit
from tnc_tpu.contractionpath.paths import Greedy, OptMethod
from tnc_tpu.tensornetwork.simplify import simplify_network
from tnc_tpu_torch.contractionpath.contraction_path import ContractionPath
from tnc_tpu_torch.tensornetwork.tensor import CompositeTensor, LeafTensor
from tnc_tpu_torch.tensornetwork.tensordata import TensorData


def _instance(seed=4, qubits=16, depth=8):
    """The reference test's instance, with the port's copy of its leaves
    (legs, dims and data) and its replace-left path."""
    rng = np.random.default_rng(seed)
    tn = simplify_network(random_circuit(qubits, depth, 0.5, 0.5, rng,
                                         ConnectivityLayout.SYCAMORE, bitstring="0" * qubits))
    result = Greedy(OptMethod.GREEDY).find_path(tn)
    port = [LeafTensor(list(t.legs), list(t.bond_dims),
                       TensorData.matrix(np.asarray(t.data.into_data())))
            for t in tn.tensors]
    return tn, result, port, list(result.replace_path().toplevel)


def _key(sl):
    return None if sl is None else (tuple(sl.legs), tuple(sl.dims))


@pytest.mark.parametrize("n_devices", [2, 4, 8])
def test_divisible_and_at_least_n(n_devices):
    tn, result, port, replace = _instance()
    sl = port_slicing.find_parallel_slicing(port, replace, n_devices)
    assert sl is not None
    assert sl.num_slices >= n_devices
    assert sl.num_slices % n_devices == 0
    assert _key(sl) == _key(ref_slicing.find_parallel_slicing(list(tn.tensors), replace,
                                                              n_devices))


@pytest.mark.parametrize("n_devices, divisor", [(2, 4), (4, 4), (8, 4), (8, 16), (3, 4)])
def test_target_size_respected(n_devices, divisor):
    """The memory slicing ``find_slicing`` picks at the target is kept, and
    extended only for divisibility; the reference's legs exactly."""
    tn, result, port, replace = _instance()
    target = result.size / divisor
    sl = port_slicing.find_parallel_slicing(port, replace, n_devices, target_size=target)
    want = ref_slicing.find_parallel_slicing(list(tn.tensors), replace, n_devices,
                                             target_size=target)
    assert _key(sl) == _key(want)
    if sl is not None:
        base = port_slicing.find_slicing(port, replace, target)
        assert set(base.legs) <= set(sl.legs)
        assert port_slicing.sliced_peak(port, replace, sl) <= target


def test_extra_legs_minimize_total_flops():
    """The divisibility legs are chosen by total sliced flops: the parallel
    slicing of this instance stays within 32x of the serial plan."""
    tn, result, port, replace = _instance()
    sl = port_slicing.find_parallel_slicing(port, replace, 8)
    tot = port_slicing.sliced_flops(port, replace, sl)
    assert tot == ref_slicing.sliced_flops(list(tn.tensors), replace, sl)
    assert 0 < tot <= 32 * result.flops


def test_base_and_cost_model_match_reference():
    """A ``base`` slicing is only extended; a fitted cost model scores the
    extra legs in seconds — both as the reference does."""
    from tnc_tpu.obs.calibrate import CalibratedCostModel as RefModel
    from tnc_tpu_torch.obs.calibrate import CalibratedCostModel

    tn, result, port, replace = _instance()
    base = port_slicing.find_slicing(port, replace, result.size / 8)
    ref_base = ref_slicing.Slicing(base.legs, base.dims)
    for n in (3, 8, 16):
        got = port_slicing.find_parallel_slicing(port, replace, n, base=base,
                                                 cost_model=CalibratedCostModel(*MODEL))
        want = ref_slicing.find_parallel_slicing(list(tn.tensors), replace, n,
                                                 base=ref_base, cost_model=RefModel(*MODEL))
        assert _key(got) == _key(want)
        if n == 3:  # bond dims of 2: no slice count divides by 3
            assert got is None
        else:
            assert set(base.legs) <= set(got.legs)
    with pytest.raises(ValueError, match="either base or target_size"):
        port_slicing.find_parallel_slicing(port, replace, 4, target_size=8.0, base=base)


def test_no_divisible_slicing_returns_none():
    """An open network with no closed leg, or too few extra legs allowed,
    has no divisible slicing: ``None``, as the reference."""
    chain = [LeafTensor([0], [2]), LeafTensor([0, 1], [2, 2])]
    assert port_slicing.find_parallel_slicing(chain, [(0, 1)], 4) is None
    tn, result, port, replace = _instance()
    assert port_slicing.find_parallel_slicing(port, replace, 8, max_extra_legs=1) is None
    assert ref_slicing.find_parallel_slicing(list(tn.tensors), replace, 8,
                                             max_extra_legs=1) is None


def test_planner_span():
    import tnc_tpu_torch.obs as obs
    from tnc_tpu_torch.obs.core import MetricsRegistry

    _, _, port, replace = _instance(qubits=10, depth=4)
    obs.configure(enabled=True, registry=MetricsRegistry())
    try:
        port_slicing.find_parallel_slicing(port, replace, 4)
        names = [r.name for r in obs.get_registry().span_records()]
    finally:
        obs.configure(enabled=False, registry=MetricsRegistry())
    assert "plan.find_parallel_slicing" in names


def test_rank_gate_recognizes_budget_missing_plans():
    """The composed pipeline's plan rank (the reference bench's
    ``_rank_solution``): at a deep cap, an absurd 1-byte budget leaves a
    slicing whose per-slice peak misses the target — the plan cannot run —
    while a 64 GiB budget is met; the same slicings as the reference."""
    import tnc_tpu.parallel.partitioned as ref_part
    import tnc_tpu_torch.parallel.partitioned as port_part
    from tnc_tpu.contractionpath.repartitioning import compute_solution

    tn, _, _, _ = _instance()
    ptn, ppath, _, _ = compute_solution(tn, [i % 2 for i in range(len(tn.tensors))],
                                        rng=pyrandom.Random(0))
    leaves, pairs = port_part.flatten_partitioned_path(to_port(ptn), path_to_port(ppath))
    ref_leaves, ref_pairs = ref_part.flatten_partitioned_path(ptn, ppath)
    feasible = []
    for hbm in (64 * 2**30, 1):
        target = port_part.global_slicing_target(hbm)
        got = port_part.plan_global_slicing(leaves, pairs, target, max_slices=1 << 40)
        want = ref_part.plan_global_slicing(ref_leaves, ref_pairs, target,
                                            max_slices=1 << 40)
        assert _key(got) == _key(want)
        feasible.append(port_slicing.sliced_peak(leaves, pairs, got) <= target)
    assert feasible == [True, False]


def test_spmd_fn_cache_reuses_device_function():
    """The slice-parallel executor keeps its device function (backends,
    policies, hoist plan) per placement and chunk: a second call at the
    same chunk plans nothing, another chunk builds another."""
    from tnc_tpu_torch.parallel.sliced_parallel import (
        _SPMD_FN_CACHE,
        distributed_sliced_contraction,
        make_mesh,
    )

    tn, result, port, replace = _instance(qubits=10, depth=4)
    sl = port_slicing.find_parallel_slicing(port, replace, 2, target_size=result.size / 2)
    assert sl is not None
    network, path = CompositeTensor(port), ContractionPath.simple(replace)
    mesh = make_mesh(devices=[torch.device("cpu")] * 2)
    _SPMD_FN_CACHE.clear()
    a = distributed_sliced_contraction(network, path, sl, mesh=mesh)
    assert len(_SPMD_FN_CACHE) == 1
    b = distributed_sliced_contraction(network, path, sl, mesh=mesh)
    assert len(_SPMD_FN_CACHE) == 1  # same chunk: the cached function
    assert np.array_equal(a.data.into_data(), b.data.into_data())
    distributed_sliced_contraction(network, path, sl, mesh=mesh, max_slices=2)
    assert len(_SPMD_FN_CACHE) == 2  # another chunk: another function
