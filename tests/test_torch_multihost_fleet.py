"""The port's serving fleet across two processes on the CPU: worker loss,
the draining stop and the fleet plane (the counterparts of the
reference's ``tests/test_multihost_serve.py`` drain and reassignment
companions, ``scripts/elastic_smoke.py`` and
``tests/test_fleet_obs.py::test_two_process_fleet_trace_and_counters``).

Each test spawns two gloo ranks over a ``FileStore``
(``tests/_torch_multihost_worker.py``) under its own join timeout, on
``NumpyBackend`` (the reference's bits):

- a ``stop()`` racing a round held open by a slow root broadcast waits
  behind it; the round's rows are bitwise the local rows;
- rank 1 is SIGKILLed mid-range after its slice-3 checkpoint: the root's
  bounded gather marks it lost, resumes its range from the checkpoint
  (one ``serve.elastic.reassigned``, one checkpoint resume), and the
  batch is bitwise the unfailed range partials' sum; the next round gives
  the lost process ``(0, 0)`` and does not wait for it (a divergence: the
  reference's rounds go on waiting on a lost process);
- rank 1 is slow past the root's ``timeout_s`` after reading a command,
  not dead: the root marks it lost, recomputes its rows bitwise, and
  neither the next round nor the stop waits for it; rank 1 wakes, parks,
  finds itself left out and leaves ``serve_cluster`` with
  ``ProcessExcluded`` (the reference has no such mark: its worker would
  wait on a key the root set and deleted without it);
- rank 1's ``serve.dispatch`` spans carry the root's request ids and
  dispatch sequence, and the root's ``/fleet`` lists both replicas live
  and sums rank 1's ``serve.cluster.worker_batches``.
"""

import numpy as np

import _torch_multihost_worker as worker
from tnc_tpu_torch.obs.http import metric_name


def test_two_ranks_stop_drains_a_round_held_open(tmp_path):
    root, work = worker.spawn(tmp_path, "stop_drain")
    assert len(root["results"]) == 1
    want = np.concatenate([root["local"], root["local_tail"]])
    assert root["results"][0].tobytes() == want.tobytes()
    assert root["stop_s"] >= 0.2  # it waited behind the slow round
    assert root["refused"] and work["served"] == 1


def test_two_ranks_killed_worker_range_resumes_from_its_checkpoint(tmp_path):
    root, work = worker.spawn(tmp_path, "kill_resume", exits=(0, -9))
    assert work is None
    assert root["lost_ranges"] == [(0, 2), (2, 4)]
    assert root["got"].tobytes() == root["oracle"].tobytes()
    assert root["reassigned"] == 1 and root["lost"] == [1]
    assert root["resumed"] == {"resilience.ckpt.resumed": 1.0}
    # the next round: everything on the root, no wait on the lost rank
    assert root["next_ranges"] == [(0, 4), (0, 0)]
    assert root["again"].tobytes() == root["full"].tobytes()
    assert root["next_round_s"] < 1.5 < root["lost_round_s"]


def test_two_ranks_a_slow_worker_left_out_leaves(tmp_path):
    root, work = worker.spawn(tmp_path, "slow_excluded")
    assert work["served"] is None and "left out" in work["error"]
    assert 4.0 <= work["left_s"] < 30.0
    assert root["lost"] == [1] and root["reassigned"] == 1
    assert root["got"].tobytes() == root["shards"].tobytes()
    assert root["next_ranges"] == [(0, 4), (0, 0)]
    assert root["again"].tobytes() == root["full"].tobytes()
    assert root["next_round_s"] < 0.5 and root["stop_s"] < 0.5 <= 1.0 <= root["lost_round_s"]


def test_two_ranks_carry_the_root_trace_and_federate_counters(tmp_path):
    root, work = worker.spawn(tmp_path, "fleet_trace")
    seqs = dict(root["seqs"])
    assert len(seqs) == work["served"] == 2
    remote = [args for name, args in work["spans"] if args.get("remote") == 1]
    assert {a["seq"]: a["riders"] for a in remote} == seqs
    assert all(a["process"] == 1 and a["root_process"] == 0 for a in remote)
    view = root["view"]
    assert view["enabled"] and view["replicas"] == ["p0", "p1"]
    assert view["roster"]["live"] == 2 and not view["unreachable"]
    key = metric_name("serve.cluster.worker_batches") + "_total"
    assert view["counters"][key] == work["served"]
