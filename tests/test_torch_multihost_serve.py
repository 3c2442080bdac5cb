"""The port's multi-process serving (``tnc_tpu_torch.serve.multihost``)
against the JAX package's, on the CPU (the counterpart of
``tests/test_multihost_serve.py``, whose processes run
``jax.distributed``).

Spawned pairs (two gloo ranks over a ``FileStore``, the ranks in
``tests/_torch_multihost_worker.py``, each pair under its own join
timeout): the bra-sharded service's rows are **bitwise** the reference's
``NumpyBackend`` ``amplitudes_det`` of the same rows, with the worker
binding through the shared plan cache with no planner call; the
slice-range-sharded batch is within 1e-12 relative of the reference's
one-process slice loop (range partials re-associate the sum); a plan swap
published through the shared cache is adopted by the worker before the
next round (bitwise the swapped plan's local rows).

Single-process companions: ``shard_ranges`` and ``assign_ranges`` equal
the reference's on the same inputs (a hypothesis property where the
reference states one), a reassigned range resumes from its checkpoint
bitwise on ``NumpyBackend`` and equal to the reference's bits, and
``ClusterDispatcher.stop()`` drains an in-flight round or poisons the
dispatcher as the reference's does. The worker-loss and fleet scenarios
are in ``tests/test_torch_multihost_fleet.py``.
"""

import threading
import time

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import _torch_multihost_worker as worker
import tnc_tpu.serve as ref_serve
import tnc_tpu_torch.serve as port_serve
from tnc_tpu.builders.random_circuit import brickwork_circuit as ref_brickwork
from tnc_tpu.ops.backends import NumpyBackend as RefNumpyBackend
from tnc_tpu_torch.ops.backends import NumpyBackend

REL_SLICES = 1e-12  # complex128, range partials summed in range order


def _ref_bound(cfg, target_size=None):
    qubits, depth, seed = cfg
    return ref_serve.bind_circuit(ref_brickwork(qubits, depth, np.random.default_rng(seed)),
                                  target_size=target_size)


def _ref_amps(cfg, bits, target_size=None):
    bound = _ref_bound(cfg, target_size)
    det = [bound.template.request_bits(b) for b in bits]
    return np.asarray(bound.amplitudes_det(det, RefNumpyBackend()))


def test_two_ranks_bra_sharded_service_is_bitwise_the_reference(tmp_path):
    """24 requests in batches of 8 through a ``ClusterDispatcher``: every
    row bitwise the reference's; the worker bound from the shared cache
    (a hit, no planner call) and served each batch."""
    root, work = worker.spawn(tmp_path, "bras")
    want = _ref_amps(worker.SERVE, worker.serve_bits())
    assert root["got"].dtype == want.dtype and root["got"].tobytes() == want.tobytes()
    assert work["planned"] == 0 and work["hits"] >= 1
    assert work["served"] == root["batches"] >= 3


def test_two_ranks_slice_ranges_sum_to_the_reference(tmp_path):
    """Each rank sums its half of the 4 slices; the root's sum of the range
    partials is within 1e-12 relative of the reference's slice loop."""
    root, work = worker.spawn(tmp_path, "slices")
    want = _ref_amps(worker.SLICED, worker.serve_bits()[:6], worker.SLICED_TARGET)
    assert root["slices"] == work["slices"] == 4
    assert work["planned"] == 0 and work["got"] is None
    got = root["got"]
    assert got.shape == want.shape
    assert float(np.max(np.abs(got - want))) <= REL_SLICES * float(np.max(np.abs(want)))


def test_two_ranks_adopt_a_plan_swap_through_the_shared_cache(tmp_path):
    """The root swaps in another plan of the same structure and publishes it
    through the shared cache: the worker rebinds once from the cache (no
    planner call), and each round is bitwise the local rows of the plan it
    ran under; both within 1e-12 of the reference's."""
    root, work = worker.spawn(tmp_path, "plan_swap")
    assert root["old_sig"] != root["new_sig"] and root["swaps"] == 1
    assert work["rebinds"] == {"serve.cluster.worker_rebinds": 1.0}
    assert work["planned"] == 0 and work["served"] == 2
    assert root["first"].tobytes() == root["first_local"].tobytes()
    assert root["second"].tobytes() == root["second_local"].tobytes()
    want = _ref_amps(worker.SERVE, worker.serve_bits()[:12])
    got = np.concatenate([root["first"], root["second"]])
    assert float(np.max(np.abs(got - want))) <= 1e-12 * float(np.max(np.abs(want)))


@given(st.integers(-3, 40), st.integers(-1, 9))
@settings(max_examples=60, deadline=None)
def test_shard_ranges_equal_the_reference(n_items, n_parts):
    got = port_serve.shard_ranges(n_items, n_parts)
    assert got == ref_serve.shard_ranges(n_items, n_parts)
    flat = [i for lo, hi in got for i in range(lo, hi)]
    assert flat == list(range(max(n_items, 0)))


def test_assign_ranges_under_churn_equal_the_reference():
    """A churning fleet's successive rounds: the port's placement is the
    reference's, dead slots empty, live slots covering the items in order."""
    n = 3
    for live in [{0, 1, 2}, {0, 2}, {2}, set(), {0, 1, 2}, {1}, {0, 5}]:
        for n_items in (0, 1, 4, 10):
            got = port_serve.assign_ranges(n_items, live, n)
            assert got == ref_serve.assign_ranges(n_items, live, n)
            flat = [i for lo, hi in got for i in range(lo, hi)]
            assert flat == list(range(n_items))


def test_reassigned_range_resumes_from_checkpoint_bitwise(tmp_path, monkeypatch):
    """A worker dies after its slice-3 checkpoint of range (2, 4); the
    survivor's rerun against the shared directory skips the completed slice
    (a fatal rule on it stays silent) and gives the unfailed range's bits,
    which are the reference's; a batch whose second request never
    checkpointed is bitwise the unfailed batch too."""
    from tnc_tpu_torch.resilience.faultinject import InjectedFatal, faults

    monkeypatch.setenv("TNC_TPU_CKPT_EVERY", "1")
    backend = NumpyBackend()
    bound = port_serve.bind_circuit(worker._circuit(worker.SLICED),
                                    target_size=worker.SLICED_TARGET)
    ref = _ref_bound(worker.SLICED, worker.SLICED_TARGET)
    assert bound.sliced.slicing.num_slices == 4
    ranges = port_serve.assign_ranges(4, {0, 1}, 2)
    assert ranges == [(0, 2), (2, 4)]
    det = worker._det(bound, ["00000011"])
    parts = [np.asarray(bound.amplitudes_det(det, backend, slice_range=r)) for r in ranges]
    ref_det = [ref.template.request_bits(b) for b in ["00000011"]]
    ref_parts = [np.asarray(ref.amplitudes_det(ref_det, RefNumpyBackend(), slice_range=r))
                 for r in ranges]
    assert all(p.tobytes() == q.tobytes() for p, q in zip(parts, ref_parts))
    ckpt = str(tmp_path / "ckpt")
    with faults("sliced.slice(s=3)=fatal*1"), pytest.raises(InjectedFatal):
        bound.amplitudes_det(det, backend, slice_range=(2, 4), ckpt=ckpt)
    with faults("sliced.slice(s=2)=fatal*1"):
        resumed = np.asarray(bound.amplitudes_det(det, backend, slice_range=(2, 4), ckpt=ckpt))
    assert resumed.tobytes() == parts[1].tobytes()
    assert (parts[0] + resumed).tobytes() == (parts[0] + parts[1]).tobytes()

    det2 = worker._det(bound, ["00000011", "01001101"])
    oracle2 = np.asarray(bound.amplitudes_det(det2, backend, slice_range=(2, 4)))
    ckpt2 = str(tmp_path / "ckpt2")
    with faults("sliced.slice(s=3)=fatal*1"), pytest.raises(InjectedFatal):
        bound.amplitudes_det(det2, backend, slice_range=(2, 4), ckpt=ckpt2)
    resumed2 = np.asarray(bound.amplitudes_det(det2, backend, slice_range=(2, 4), ckpt=ckpt2))
    assert resumed2.tobytes() == oracle2.tobytes()


class _LocalBound:
    """A dispatcher target for one process (no group: local execution)."""

    sliced = None

    def amplitudes_det(self, bits, backend=None, **kw):
        return np.zeros(len(bits), dtype=complex)


@pytest.mark.parametrize("package", ["port", "ref"])
def test_dispatcher_stop_drains_inflight_round(package):
    """``stop()`` serializes behind a round held open by a slow root
    broadcast: a bounded drain that expires poisons the dispatcher
    (``TimeoutError``); a plain stop waits and the round completes. Later
    calls raise ``DispatcherStoppedError`` — the reference's behaviour."""
    if package == "port":
        from tnc_tpu_torch.resilience.faultinject import faults
        serve = port_serve
    else:
        from tnc_tpu.resilience.faultinject import faults
        serve = ref_serve
    bound = _LocalBound()
    d = serve.ClusterDispatcher()
    with faults("cluster.broadcast(side=root)=slow:0.6*1"):
        t = threading.Thread(target=lambda: d(bound, ["00"]))
        t.start()
        time.sleep(0.15)
        with pytest.raises(TimeoutError):
            d.stop(drain_timeout_s=0.05)
        t.join(30)
    with pytest.raises(serve.DispatcherStoppedError):
        d(bound, ["00"])
    d.stop()

    d2 = serve.ClusterDispatcher()
    results = []
    with faults("cluster.broadcast(side=root)=slow:0.4*1"):
        t = threading.Thread(target=lambda: results.append(d2(bound, ["00", "11"])))
        t.start()
        time.sleep(0.15)
        d2.stop()
        t.join(30)
    assert len(results) == 1 and results[0].shape == (2,)
    with pytest.raises(serve.DispatcherStoppedError):
        d2(bound, ["00"])
