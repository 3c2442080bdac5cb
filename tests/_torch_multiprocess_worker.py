"""One rank of the port's two-process tests (``tests/test_torch_multiprocess.py``;
the counterpart of ``tests/_multihost_worker.py``).

The test spawns ``run(rank, world, store_path, scenario, out_dir)`` in each
of two processes (the ``spawn`` start method): the rank joins a gloo
process group over a ``FileStore`` at ``store_path``, runs the named
scenario on the CPU, writes what it returns to ``out_dir/<rank>.pkl`` and
leaves the group. Imports torch and the port only, never JAX.
"""

import os
import pickle

import numpy as np


def _partitioned(k=4, qubits=8, depth=4, seed=7):
    """The same partitioned network and path on every rank (a seeded LINE
    random circuit, ``find_partitioning``, ``Greedy`` over the blocks)."""
    from tnc_tpu_torch.builders.connectivity import ConnectivityLayout
    from tnc_tpu_torch.builders.random_circuit import random_circuit
    from tnc_tpu_torch.contractionpath.paths import Greedy, OptMethod
    from tnc_tpu_torch.tensornetwork.partitioning import (
        find_partitioning,
        partition_tensor_network,
    )
    from tnc_tpu_torch.tensornetwork.tensor import CompositeTensor

    tn = random_circuit(qubits, depth, 0.9, 0.8, np.random.default_rng(seed),
                        ConnectivityLayout.LINE)
    grouped = partition_tensor_network(CompositeTensor(list(tn.tensors)),
                                       find_partitioning(tn, k))
    return grouped, Greedy(OptMethod.GREEDY).find_path(grouped).replace_path()


def _path_obj(p):
    return (sorted((k, _path_obj(v)) for k, v in p.nested.items()),
            [tuple(pair) for pair in p.toplevel])


def broadcast_path(rank, world):
    from tnc_tpu_torch.contractionpath.contraction_path import ContractionPath
    from tnc_tpu_torch.parallel.partitioned import broadcast_path as bcast

    if rank == 0:
        _, path = _partitioned()
    else:
        path = ContractionPath.simple([])  # the real path arrives by broadcast
    return _path_obj(bcast(path, root=0))


def process_sharded(rank, world):
    """The process-sharded executor on both ranks (partitions 0/2 and 1/3,
    cross-rank pairs over the store), and the single-process executor on
    this rank's own: the same bits, complex128 and split float32."""
    import torch

    from tnc_tpu_torch.parallel.partitioned import distributed_partitioned_contraction

    grouped, path = _partitioned()
    out = {}
    for dtype, split in (("complex128", False), ("complex64", True)):
        sharded = distributed_partitioned_contraction(
            grouped, path, dtype=dtype, split_complex=split, device="cpu")
        single = distributed_partitioned_contraction(
            grouped, path, devices=[torch.device("cpu")] * len(grouped), dtype=dtype,
            split_complex=split)
        out[dtype] = (sharded.data.into_data(), single.data.into_data())
    return out


def send_recv(rank, world):
    """A point-to-point exchange each way under one namespace."""
    from tnc_tpu_torch.parallel.partitioned import p2p_sequence, recv_object, send_object

    seq = p2p_sequence()
    payload = {"from": rank, "data": np.arange(6, dtype=np.complex64) * (rank + 1)}
    other = 1 - rank
    send_object(payload, seq, slot=rank)
    return recv_object(seq, slot=other)


def gather_lost(rank, world):
    """A gather every rank joins, then one rank 1 withholds from: rank 0's
    slot of it holds ``GatherLost(1)`` after the timeout."""
    from tnc_tpu_torch.parallel.partitioned import gather_objects

    first = gather_objects({"rank": rank}, timeout_s=30)
    second = None
    if rank == 0:
        second = gather_objects("mine", timeout_s=2, missing_ok=True)
    return first, second


def _sliced():
    """A seeded 12-qubit SYCAMORE circuit, ``Greedy``, and a parallel
    slicing of 8 slices or more (the same on every rank)."""
    from tnc_tpu_torch.builders.connectivity import ConnectivityLayout
    from tnc_tpu_torch.builders.random_circuit import random_circuit
    from tnc_tpu_torch.contractionpath.paths import Greedy, OptMethod
    from tnc_tpu_torch.contractionpath.slicing import find_parallel_slicing
    from tnc_tpu_torch.tensornetwork.simplify import simplify_network

    tn = simplify_network(random_circuit(12, 6, 0.5, 0.5, np.random.default_rng(4),
                                         ConnectivityLayout.SYCAMORE, bitstring="0" * 12))
    result = Greedy(OptMethod.GREEDY).find_path(tn)
    path = result.replace_path()
    slicing = find_parallel_slicing(list(tn.tensors), path.toplevel, 8,
                                    target_size=result.size / 4)
    return tn, path, slicing


def sliced_all_reduce(rank, world):
    """``distributed_sliced_contraction`` over the two ranks (each its half
    of the slices, then ``all_reduce``) and the one-process sum of the same
    slices."""
    import torch

    from tnc_tpu_torch.parallel.sliced_parallel import distributed_sliced_contraction, make_mesh

    tn, path, slicing = _sliced()
    out = {"slices": slicing.num_slices}
    for dtype, split in (("complex128", False), ("complex64", True)):
        group = distributed_sliced_contraction(tn, path, slicing, dtype=dtype,
                                               split_complex=split, device="cpu")
        one = distributed_sliced_contraction(
            tn, path, slicing, mesh=make_mesh(devices=[torch.device("cpu")]), dtype=dtype,
            split_complex=split)
        out[dtype] = (group.data.into_data(), one.data.into_data())
    return out


def sliced_retry(rank, world):
    """Rank 1's first dispatch of the group's sliced contraction fails (a
    transient fault at ``spmd.dispatch``) and is retried. Returns the sum
    without the fault, the sum with it, the ``all_reduce`` calls of the
    faulted run and the faults left unfired."""
    import torch.distributed as dist

    from tnc_tpu_torch.parallel.sliced_parallel import distributed_sliced_contraction
    from tnc_tpu_torch.resilience import faultinject

    tn, path, slicing = _sliced()

    def run():
        return distributed_sliced_contraction(tn, path, slicing, dtype="complex128",
                                              split_complex=False, device="cpu")

    clean = run().data.into_data()
    calls = []
    all_reduce = dist.all_reduce

    def counted(*args, **kwargs):
        calls.append(1)
        return all_reduce(*args, **kwargs)

    dist.all_reduce = counted
    try:
        with faultinject.faults("spmd.dispatch=transient*1" if rank == 1 else None):
            faulted = run().data.into_data()
            unfired = sum(r.remaining for r in faultinject._RULES)
    finally:
        dist.all_reduce = all_reduce
    return {"clean": clean, "faulted": faulted, "all_reduce_calls": len(calls),
            "unfired": unfired}


SCENARIOS = {f.__name__: f for f in (broadcast_path, process_sharded, send_recv,
                                     gather_lost, sliced_all_reduce, sliced_retry)}


def run(rank: int, world: int, store_path: str, scenario: str, out_dir: str) -> None:
    import torch.distributed as dist

    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        result = SCENARIOS[scenario](rank, world)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)
