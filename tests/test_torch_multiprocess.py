"""The port's multi-process paths on the CPU: two spawned ranks in a gloo
process group over a ``FileStore`` (the counterpart of
``tests/test_multihost.py``, whose ranks run ``jax.distributed``).

Each test spawns the two ranks of ``tests/_torch_multiprocess_worker.py``
with one scenario — ``broadcast_path``, the process-sharded partitioned
contraction against the single-process one (bitwise), ``send_object`` /
``recv_object``, ``gather_objects`` with a rank that withholds its part,
and the slice-parallel ``all_reduce``, also after a retried fault on one
rank — and joins them under a timeout of its own: a rank that hangs fails
its test (the group is killed first) and a rank that fails fails it too.
"""

import multiprocessing
import os
import pickle

import numpy as np
import pytest

import _torch_multiprocess_worker as worker

WORLD = 2
JOIN_S = 90.0


def spawn(tmp_path, scenario: str) -> list:
    ctx = multiprocessing.get_context("spawn")
    store = str(tmp_path / "store")
    procs = [ctx.Process(target=worker.run, args=(rank, WORLD, store, scenario,
                                                  str(tmp_path)))
             for rank in range(WORLD)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(JOIN_S)
        hung = [rank for rank, p in enumerate(procs) if p.is_alive()]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    assert not hung, f"{scenario}: ranks {hung} still running after {JOIN_S} s"
    codes = [p.exitcode for p in procs]
    assert codes == [0] * WORLD, f"{scenario}: exit codes {codes}"
    out = []
    for rank in range(WORLD):
        with open(tmp_path / f"{rank}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def test_broadcast_path(tmp_path):
    """Rank 0 plans; rank 1 receives the nested path over the store."""
    got = spawn(tmp_path, "broadcast_path")
    assert got[0] == got[1]
    nested, toplevel = got[1]
    assert toplevel and len(nested) == 4


def test_process_sharded_matches_single_process_bitwise(tmp_path):
    """Partitions sharded over the ranks, cross-rank pairs shipped as host
    objects, the final tensor broadcast: every rank holds the
    single-process executor's bits, in complex128 and split float32."""
    got = spawn(tmp_path, "process_sharded")
    for dtype in ("complex128", "complex64"):
        single = got[0][dtype][1]
        for rank in range(WORLD):
            sharded, own_single = got[rank][dtype]
            assert np.array_equal(own_single, single)
            assert np.array_equal(sharded, single), (dtype, rank)
            assert np.all(np.isfinite(sharded))


def test_send_and_recv_objects(tmp_path):
    got = spawn(tmp_path, "send_recv")
    for rank in range(WORLD):
        other = 1 - rank
        assert got[rank]["from"] == other
        np.testing.assert_array_equal(got[rank]["data"],
                                      np.arange(6, dtype=np.complex64) * (other + 1))


def test_gather_objects_marks_a_withheld_slot_lost(tmp_path):
    from tnc_tpu_torch.parallel.partitioned import GatherLost

    got = spawn(tmp_path, "gather_lost")
    assert got[0][0] == [{"rank": 0}, {"rank": 1}]
    assert got[1][0] is None  # only the root gathers
    assert got[0][1] == ["mine", GatherLost(1)]


def test_sliced_all_reduce_agrees_with_one_process(tmp_path):
    """Each rank sums its half of the slices and ``all_reduce`` adds them:
    the ranks agree bitwise and the sum matches one process's (another
    summation order) within 1e-10 in complex128 and 1e-5 in split float32."""
    got = spawn(tmp_path, "sliced_all_reduce")
    assert got[0]["slices"] % WORLD == 0
    for dtype, rel in (("complex128", 1e-10), ("complex64", 1e-5)):
        group0, one = got[0][dtype]
        group1, _ = got[1][dtype]
        assert np.array_equal(group0, group1)
        a, b = complex(group0.reshape(-1)[0]), complex(one.reshape(-1)[0])
        assert abs(a - b) <= rel * abs(b)


def test_sliced_retry_reruns_the_share_and_reduces_once(tmp_path):
    """A transient failure on one rank retries that rank's own share only:
    each rank calls ``all_reduce`` once, and both hold the bits of a run
    without the fault."""
    got = spawn(tmp_path, "sliced_retry")
    for rank in range(WORLD):
        assert got[rank]["unfired"] == 0
        assert got[rank]["all_reduce_calls"] == 1
        assert np.array_equal(got[rank]["faulted"], got[rank]["clean"]), rank
    assert np.array_equal(got[0]["faulted"], got[1]["faulted"])


def test_store_timeout_is_transient(tmp_path):
    """An expired store wait is the reference's ``TimeoutError``, which the
    retry policy classifies TRANSIENT."""
    import torch.distributed as dist

    from tnc_tpu_torch.parallel.partitioned import _store_wait
    from tnc_tpu_torch.resilience.retry import FailureClass, classify_exception

    store = dist.FileStore(str(tmp_path / "solo"), 1)
    with pytest.raises(TimeoutError) as exc_info:
        _store_wait(store, ["never"], 50)
    assert classify_exception(exc_info.value) is FailureClass.TRANSIENT
    store.set("there", b"1")
    _store_wait(store, ["there"], 50)
