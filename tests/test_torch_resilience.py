"""The port's resilience frames (``tnc_tpu_torch.resilience``, the retry
frame of ``TorchBackend``, the chunked executor's retry, OOM rung and
checkpoints) and its metrics surface (``tnc_tpu_torch.obs.core``) against
the JAX package on the CPU.

- ``classify_exception`` gives the reference's class on the reference's
  cases; PyTorch's out-of-memory error is RESOURCE, a sticky CUDA error
  and the port's own kernel build or launch error FATAL (and no retry
  spins on them); ``RetryPolicy`` retries as the reference's does.
- ``parse_spec`` gives the reference's rules, ``fault_point`` fires as the
  reference's does; ``SliceCheckpoint``, ``signature_hash`` and
  ``arrays_digest`` agree with the reference's.
- ``execute_sliced_numpy`` with ``ckpt=`` or ``on_slice=``: interrupted
  by a fault or a yield and resumed, it gives the uninterrupted run's bits
  and the reference's (``sycamore_circuit(20, 6, rng 7)``, 4 slices, where
  the two oracles agree bitwise), yielding at the reference's cursor.
- The chunked executor on ``TorchBackend(device="cpu")``
  (``sycamore_circuit(20, 8, rng 7)``, 16 slices, batch 4): resumed after
  an injected ``chunked.batch`` fault, bitwise the uninterrupted run; an
  injected ``oom`` halves the batch; a transient retries in place; a
  ``graphs.capture`` fault inside a (stand-in) capture retries the batch.
- ``TorchBackend``'s dispatch retries a transient ``backend.dispatch``
  fault with the same bits and re-raises a fatal one.
- ``QuantileSummary`` and the registry's metrics agree with the
  reference's.
"""

import doctest
import glob
import json
import logging
import multiprocessing

import numpy as np
import pytest
import torch

import tnc_tpu.obs.core as ref_obs_core
import tnc_tpu.resilience.checkpoint as ref_ckpt
import tnc_tpu.resilience.faultinject as ref_faults
import tnc_tpu.resilience.retry as ref_retry
import tnc_tpu_torch.obs.core as port_obs_core
import tnc_tpu_torch.ops.graphs as port_graphs
import tnc_tpu_torch.resilience as port_resilience
import tnc_tpu_torch.resilience.checkpoint as port_ckpt
import tnc_tpu_torch.resilience.faultinject as port_faults
import tnc_tpu_torch.resilience.retry as port_retry
from tests._torch_sliced_cases import SIXTEEN, SMALL, _both
from tnc_tpu.ops.sliced import SliceYield as RefSliceYield
from tnc_tpu.ops.sliced import execute_sliced_numpy as ref_execute_sliced_numpy
from tnc_tpu_torch import obs
from tnc_tpu_torch.ops.backends import NumpyBackend, TorchBackend
from tnc_tpu_torch.ops.program import build_program, flat_leaf_tensors
from tnc_tpu_torch.ops.sliced import SliceYield, execute_sliced_numpy


@pytest.fixture(autouse=True)
def quick_retries():
    """No backoff on either side, restored after; a fresh, enabled obs
    registry in the port (its resilience counters read back), restored."""
    for mod in (port_retry, ref_retry):
        mod.configure_retry(mod.RetryPolicy(max_attempts=3, base_delay_s=0.0))
    saved = (port_obs_core._ENABLED, port_obs_core._REGISTRY)
    obs.configure(enabled=True, registry=port_obs_core.MetricsRegistry())
    yield
    for mod in (port_retry, ref_retry):
        mod.configure_retry(None)
    port_obs_core._ENABLED, port_obs_core._REGISTRY = saved


# --- classification and retry ---------------------------------------------


class _Chained(RuntimeError):
    pass


def _chained(outer: str, inner: BaseException) -> BaseException:
    try:
        raise _Chained(outer) from inner
    except _Chained as e:
        return e


REFERENCE_CASES = {
    "resource_exhausted": lambda m: RuntimeError("RESOURCE_EXHAUSTED: out of memory"),
    "failed_to_allocate": lambda m: RuntimeError("Failed to allocate 2GiB"),
    "oom_word": lambda m: RuntimeError("device OOM while running"),
    "room_is_not_oom": lambda m: RuntimeError("no room in the bloom filter"),
    "connection_reset": lambda m: ConnectionResetError("peer vanished"),
    "timeout": lambda m: TimeoutError("took too long"),
    "mp_timeout": lambda m: multiprocessing.TimeoutError(),
    "unavailable": lambda m: RuntimeError("UNAVAILABLE: socket closed"),
    "deadline": lambda m: RuntimeError("DEADLINE_EXCEEDED: rpc"),
    "preempted": lambda m: RuntimeError("the host was preempted"),
    "oom_beats_aborted": lambda m: RuntimeError("ABORTED: RESOURCE_EXHAUSTED"),
    "value_error": lambda m: ValueError("bad shape"),
    "cause_transient": lambda m: _chained("wrapper", ConnectionResetError("x")),
    "exhausted": lambda m: m.RetryExhaustedError(
        "site", 3, RuntimeError("UNAVAILABLE: x")),
    "wrapped_exhausted": lambda m: _chained(
        "wrapper", m.RetryExhaustedError("site", 3, RuntimeError("UNAVAILABLE"))),
}


@pytest.mark.parametrize("case", sorted(REFERENCE_CASES))
def test_classify_matches_reference(case):
    make = REFERENCE_CASES[case]
    got = port_retry.classify_exception(make(port_retry))
    want = ref_retry.classify_exception(make(ref_retry))
    assert got.value == want.value


@pytest.mark.parametrize("kind", ["oom", "transient", "preempt", "fatal"])
def test_injected_faults_classify_as_the_reference(kind):
    port_exc, port_msg = port_faults._KINDS[kind]
    ref_exc, ref_msg = ref_faults._KINDS[kind]
    assert port_msg == ref_msg
    got = port_retry.classify_exception(port_exc(port_msg.format(site="s")))
    want = ref_retry.classify_exception(ref_exc(ref_msg.format(site="s")))
    assert got.value == want.value


TORCH_CASES = {
    "torch_oom": (lambda: torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB"), "resource"),
    "bare_torch_oom": (lambda: torch.cuda.OutOfMemoryError(), "resource"),
    "illegal_memory_access": (lambda: RuntimeError(
        "CUDA error: an illegal memory access was encountered"), "fatal"),
    "unspecified_launch_failure": (lambda: RuntimeError(
        "CUDA error: unspecified launch failure"), "fatal"),
    "device_assert": (lambda: RuntimeError(
        "CUDA error: device-side assert triggered"), "fatal"),
    "misaligned": (lambda: RuntimeError("CUDA error: misaligned address"), "fatal"),
    "sticky_under_unavailable": (lambda: RuntimeError(
        "UNAVAILABLE: an illegal memory access was encountered"), "fatal"),
    "sticky_under_oom_text": (lambda: RuntimeError(
        "out of memory after an illegal memory access was encountered"), "fatal"),
    "kernel_launch": (lambda: RuntimeError(
        "fused_chain kernel failed: CUDA error 700 (an illegal memory access "
        "was encountered)"), "fatal"),
    "kernel_launch_oom_code": (lambda: RuntimeError(
        "fused_complex_dot kernel failed: CUDA error 2 (out of memory)"), "fatal"),
    "kernel_build": (lambda: RuntimeError("kernel build failed:\nptxas error"), "fatal"),
    "no_nvcc": (lambda: RuntimeError("nvcc not found (set CUDA_HOME)"), "fatal"),
    "wrapped_sticky": (lambda: _chained(
        "batch failed", RuntimeError("CUDA error: unspecified launch failure")), "fatal"),
}


@pytest.mark.parametrize("case", sorted(TORCH_CASES))
def test_classify_torch_errors(case):
    make, want = TORCH_CASES[case]
    assert port_retry.classify_exception(make()).value == want


@pytest.mark.parametrize("case", ["illegal_memory_access", "kernel_launch", "torch_oom"])
def test_no_retry_spins_on_sticky_or_oom_errors(case):
    """A FATAL or RESOURCE failure re-raises on the first attempt."""
    make, _ = TORCH_CASES[case]
    calls = []

    def fn():
        calls.append(1)
        raise make()

    with pytest.raises(Exception):
        port_retry.RetryPolicy(max_attempts=5, base_delay_s=0.0).run(fn)
    assert len(calls) == 1


@pytest.mark.parametrize("fails", [0, 1, 2, 3, 5])
@pytest.mark.parametrize("retry_resource", [False, True])
def test_retry_policy_matches_reference(fails, retry_resource):
    """Attempts, results and the exhaustion message match the reference's
    for a function failing ``fails`` times (transient) then succeeding."""

    def outcome(mod):
        calls = []
        slept = []

        def fn():
            calls.append(1)
            if len(calls) <= fails:
                raise ConnectionResetError(f"blip {len(calls)}")
            return "ok"

        policy = mod.RetryPolicy(max_attempts=3, base_delay_s=0.0,
                                 retry_resource=retry_resource, sleep=slept.append)
        try:
            result = policy.run(fn, label="site")
        except mod.RetryExhaustedError as e:
            result = (str(e), e.attempts, type(e.__cause__).__name__)
        return result, len(calls), len(slept)

    assert outcome(port_retry) == outcome(ref_retry)


def test_retry_resource_only_when_asked():
    def run(retry_resource):
        calls = []

        def fn():
            calls.append(1)
            if len(calls) == 1:
                raise torch.cuda.OutOfMemoryError("CUDA out of memory")
            return len(calls)

        try:
            return port_retry.RetryPolicy(
                max_attempts=3, base_delay_s=0.0, retry_resource=retry_resource).run(fn)
        except torch.cuda.OutOfMemoryError:
            return "raised"

    assert run(False) == "raised" and run(True) == 2


def test_retry_counters_and_default_policy(monkeypatch):
    calls = []

    def fn():
        calls.append(1)
        if len(calls) == 1:
            raise TimeoutError("blip")
        return 1

    port_retry.retry_call(fn, label="demo")
    assert obs.counters_by_prefix("resilience.retry") == {
        "resilience.retry.attempts{site=demo}": 1.0,
        "resilience.retry.errors{cls=transient,site=demo}": 1.0,
    }
    monkeypatch.setenv("TNC_TPU_RETRY_ATTEMPTS", "7")
    monkeypatch.setenv("TNC_TPU_RETRY_BASE_S", "0.5")
    for mod in (port_retry, ref_retry):
        mod.configure_retry(None)
    assert repr(port_retry.default_policy()) == repr(ref_retry.default_policy())
    assert port_retry.default_policy().max_attempts == 7


@pytest.mark.parametrize("value,want", [("1", True), ("on", True), ("0", False), ("", False)])
def test_sync_dispatch_flag(monkeypatch, value, want):
    monkeypatch.setenv("TNC_TPU_SYNC_DISPATCH", value)
    assert port_retry.sync_dispatch() is want is ref_retry.sync_dispatch()


def test_nothing_is_donated():
    """A torch dispatch consumes no buffer: the donation guard never
    downgrades a transient failure."""
    buffers = [torch.zeros(2), (torch.zeros(1), torch.zeros(1)), np.zeros(3)]
    assert port_retry.buffers_alive(buffers)
    classify = port_retry.donation_guarded_classify(buffers)
    assert classify(ConnectionResetError("x")) is port_retry.FailureClass.TRANSIENT


class _Pool:
    def __init__(self, fail_with=None):
        self.fail_with = fail_with
        self.terminated = False

    def terminate(self):
        self.terminated = True


@pytest.mark.parametrize("first,second", [
    ("timeout", None), ("timeout", "timeout"), ("value", None)])
def test_pool_map_with_retry_matches_reference(first, second):
    errors = {"timeout": TimeoutError("wedged"), "value": ValueError("bug"), None: None}

    def outcome(mod):
        pools = [_Pool(errors[first]), _Pool(errors[second])]
        made = iter(pools[1:])

        def submit(pool):
            if pool.fail_with is not None:
                raise pool.fail_with
            return "results"

        results, survivor = mod.pool_map_with_retry(
            pools[0], submit, lambda: next(made), logging.getLogger("t"), "search")
        return results, survivor is not None, [p.terminated for p in pools]

    assert outcome(port_retry) == outcome(ref_retry)


# --- fault injection ------------------------------------------------------


SPECS = [
    "chunked.batch=oom",
    "chunked.batch(start=8)=fatal*1",
    "chunked.batch(start=8, batch=4)=transient*2; backend.dispatch=preempt*-1",
    "serve.dispatch=slow:0.2*-1",
    "serve.dispatch(kind=amplitude)=slow*3",
    " sliced.slice(s=3) = kill * 1 ; ",
    "partition.local(partition=1)=oom*1;chunked.plan=fatal",
]


def _rules(rules):
    return [(r.site, r.conds, r.kind, r.remaining, r.arg) for r in rules]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_spec_matches_reference(spec):
    assert _rules(port_faults.parse_spec(spec)) == _rules(ref_faults.parse_spec(spec))


@pytest.mark.parametrize("spec", [
    "chunked.batch", "chunked.batch=explode", "chunked.batch=slow:-1",
    "=oom", "chunked.batch(start=8=oom", "chunked.batch(start)=oom"])
def test_malformed_specs_raise_like_reference(spec):
    with pytest.raises(ValueError):
        ref_faults.parse_spec(spec)
    with pytest.raises(ValueError):
        port_faults.parse_spec(spec)


def test_fault_points_fire_like_reference():
    """The same calls under the same script raise the same errors, the
    same number of times."""
    spec = "a.site(x=1)=oom*2; a.site=transient*1; b.site=fatal*-1"
    calls = [("a.site", {"x": 0}), ("a.site", {"x": 1}), ("a.site", {"x": 1}),
             ("a.site", {"x": 1}), ("a.site", {"x": 2}), ("b.site", {}), ("b.site", {}),
             ("c.site", {})]

    def outcomes(mod):
        out = []
        with mod.faults(spec):
            for site, ctx in calls:
                try:
                    mod.fault_point(site, **ctx)
                    out.append(None)
                except mod.InjectedFault as e:
                    out.append((type(e).__name__, str(e)))
        mod.fault_point("b.site")  # disabled again outside
        return out

    assert outcomes(port_faults) == outcomes(ref_faults)
    assert not port_faults.enabled()
    assert obs.counters_by_prefix("resilience.faults") == {
        "resilience.faults.fired{kind=fatal,site=b.site}": 2.0,
        "resilience.faults.fired{kind=oom,site=a.site}": 2.0,
        "resilience.faults.fired{kind=transient,site=a.site}": 1.0,
    }


# --- checkpoints ------------------------------------------------------------


def test_checkpoint_digests_match_reference():
    parts = ("chunked-v1", (1, (2, 3)), "complex64", 16, None, 2.5)
    assert port_ckpt.signature_hash(*parts) == ref_ckpt.signature_hash(*parts)
    arrays = [np.arange(6.0).reshape(2, 3), np.ones(4, dtype=np.complex64)]
    assert port_ckpt.arrays_digest(arrays) == ref_ckpt.arrays_digest(arrays)
    assert port_ckpt.arrays_digest(arrays) != port_ckpt.arrays_digest(arrays[:1])


def test_checkpoint_files_interchange_with_reference(tmp_path):
    """A file either package writes, the other loads, with the cursor and
    the arrays bitwise."""
    arrays = [np.arange(3.0), np.array([1 + 2j, 3 - 4j], dtype=np.complex64)]
    for writer, reader in ((port_ckpt, ref_ckpt), (ref_ckpt, port_ckpt)):
        writer.SliceCheckpoint(tmp_path, "sig", every=1).save(12, arrays)
        cursor, got = reader.SliceCheckpoint(tmp_path, "sig").load()
        assert cursor == 12
        assert all(a.tobytes() == b.tobytes() and a.dtype == b.dtype
                   for a, b in zip(got, arrays))


def test_checkpoint_cadence_and_bad_files(tmp_path, monkeypatch):
    monkeypatch.setenv("TNC_TPU_CKPT_EVERY", "4")
    ck = port_ckpt.SliceCheckpoint(tmp_path, "sig")
    assert ck.every == 4
    assert not ck.maybe_save(3, lambda: pytest.fail("not due"))
    assert ck.maybe_save(4, lambda: [np.zeros(1)])
    assert port_ckpt.SliceCheckpoint(tmp_path, "other").load() is None
    ck.file.write_bytes(b"torn")
    assert port_ckpt.SliceCheckpoint(tmp_path, "sig").load() is None
    monkeypatch.delenv("TNC_TPU_CKPT_EVERY")
    monkeypatch.setenv("TNC_TPU_CKPT_SECS", "0")
    ck = port_ckpt.SliceCheckpoint(tmp_path / "exact.npz", "sig")
    assert ck.every is None and ck.maybe_save(1, lambda: [np.ones(2)])
    assert ck.file == tmp_path / "exact.npz"
    ck.finalize()
    assert not ck.file.exists()
    assert port_ckpt.resolve_ckpt("x") == "x"
    monkeypatch.setenv("TNC_TPU_CKPT", str(tmp_path))
    assert port_ckpt.resolve_ckpt() == str(tmp_path) == ref_ckpt.resolve_ckpt()


def _small():
    both = _both(SMALL)
    return both["port"], both["ref"]


@pytest.mark.parametrize("hoist", [False, True])
def test_numpy_oracle_resumes_after_a_fault_as_reference(tmp_path, monkeypatch, hoist):
    """A fault at slice 2 interrupts both oracles; each resumes from its
    checkpoint at cursor 2 with the uninterrupted bits, which are the
    reference's bits; the finished run deletes its checkpoint."""
    monkeypatch.setenv("TNC_TPU_CKPT_EVERY", "1")
    port, ref = _small()
    want = execute_sliced_numpy(port["sp"], port["arrays"], hoist=hoist)
    results = {}
    for name, run, faults, side in (
        ("port", execute_sliced_numpy, port_faults, port),
        ("ref", ref_execute_sliced_numpy, ref_faults, ref),
    ):
        d = tmp_path / name
        kw = dict(hoist=hoist, ckpt=str(d))
        with faults.faults("sliced.slice(s=2)=fatal*1"):
            with pytest.raises(faults.InjectedFatal):
                run(side["sp"], side["arrays"], **kw)
        (file,) = glob.glob(str(d / "*.npz"))
        with np.load(file) as z:
            assert json.loads(str(z["meta"]))["cursor"] == 2
        results[name] = run(side["sp"], side["arrays"], **kw)
        assert not glob.glob(str(d / "*.npz"))
    assert results["port"].tobytes() == want.tobytes() == results["ref"].tobytes()
    assert obs.counters_by_prefix("resilience.ckpt.resumed") == {
        "resilience.ckpt.resumed": 1.0}


@pytest.mark.parametrize("slice_range", [None, (1, 4)])
def test_numpy_oracle_yields_at_the_reference_cursor(tmp_path, slice_range):
    """``on_slice`` returning True at cursor 2 raises ``SliceYield(2)`` in
    both packages; the same call resumes to the uninterrupted bits."""
    port, ref = _small()
    want = execute_sliced_numpy(port["sp"], port["arrays"], slice_range=slice_range)
    seen = {}
    for name, run, yield_type, side in (
        ("port", execute_sliced_numpy, SliceYield, port),
        ("ref", ref_execute_sliced_numpy, RefSliceYield, ref),
    ):
        cursors = []

        def on_slice(cursor, _c=cursors):
            _c.append(cursor)
            return cursor == 2

        kw = dict(ckpt=str(tmp_path / name), slice_range=slice_range)
        with pytest.raises(yield_type) as info:
            run(side["sp"], side["arrays"], on_slice=on_slice, **kw)
        seen[name] = (info.value.cursor, cursors)
        got = run(side["sp"], side["arrays"], **kw)
        assert got.tobytes() == want.tobytes()
    assert seen["port"] == seen["ref"]


def test_numpy_backend_hooks_and_other_data(tmp_path, monkeypatch):
    """``NumpyBackend`` has the hooks; a checkpoint of one bitstring's data
    is not resumed by another's."""
    monkeypatch.setenv("TNC_TPU_CKPT_EVERY", "1")
    port, _ = _small()
    backend = NumpyBackend()
    assert backend.supports_slice_hooks and not TorchBackend.supports_slice_hooks
    with port_faults.faults("sliced.slice(s=3)=fatal*1"):
        with pytest.raises(port_faults.InjectedFatal):
            backend.execute_sliced(port["sp"], port["arrays"], ckpt=str(tmp_path))
    other = [a * 2 for a in port["arrays"]]
    want = execute_sliced_numpy(port["sp"], other)
    got = backend.execute_sliced(port["sp"], other, ckpt=str(tmp_path))
    assert got.tobytes() == want.tobytes()
    assert len(glob.glob(str(tmp_path / "*.npz"))) == 1  # the first run's, untouched


# --- the chunked executor on the CPU ----------------------------------------


def _sixteen():
    return _both(SIXTEEN)["port"]


def _chunked(split, **kw):
    port = _sixteen()
    backend = TorchBackend(device="cpu", split_complex=split, slice_batch=4)
    return backend.execute_sliced(port["sp"], port["arrays"], host=False, **kw)


def _bits(result) -> bytes:
    parts = result if isinstance(result, tuple) else (result,)
    return b"".join(p.numpy().tobytes() for p in parts)


@pytest.mark.parametrize("split", [True, False])
def test_chunked_resumes_bitwise_after_a_fault(tmp_path, monkeypatch, split):
    monkeypatch.setenv("TNC_TPU_CKPT", str(tmp_path))
    monkeypatch.setenv("TNC_TPU_CKPT_EVERY", "4")
    with port_faults.faults("nothing.fires=fatal*1"):
        want = _chunked(split, ckpt=str(tmp_path / "clean"))
    assert not glob.glob(str(tmp_path / "clean" / "*"))
    with port_faults.faults("chunked.batch(start=8)=fatal*1"):
        with pytest.raises(port_faults.InjectedFatal):
            _chunked(split)
    (file,) = glob.glob(str(tmp_path / "*.npz"))
    with np.load(file) as z:
        meta = json.loads(str(z["meta"]))
        # the Kahan accumulator: (sum, compensation) of each part
        assert meta["cursor"] == 8 and meta["n"] == (4 if split else 2)
    got = _chunked(split)
    assert _bits(got) == _bits(want)
    assert not glob.glob(str(tmp_path / "*.npz"))
    assert obs.counters_by_prefix("resilience.ckpt") == {
        # the clean run saves at 4, 8, 12, 16; the faulted one at 4, 8;
        # the resumed one at 12, 16
        "resilience.ckpt.resumed": 1.0, "resilience.ckpt.saved": 8.0}


def test_chunked_resumes_at_an_unaligned_cursor(tmp_path, monkeypatch):
    """A checkpoint at cursor 6 (a batch of 2's) resumes with batch 4:
    batches [6, 10), [10, 14) and the tail [14, 16)."""
    import tnc_tpu_torch.ops.chunked as port_chunked

    port = _sixteen()
    d = str(tmp_path)
    with monkeypatch.context() as m:
        m.setenv("TNC_TPU_CKPT_EVERY", "2")
        with port_faults.faults("chunked.batch(start=6)=fatal*1"):
            with pytest.raises(port_faults.InjectedFatal):
                TorchBackend(device="cpu", split_complex=True, slice_batch=2).execute_sliced(
                    port["sp"], port["arrays"], ckpt=d)
    want = TorchBackend(device="cpu", split_complex=True, slice_batch=4).execute_sliced(
        port["sp"], port["arrays"])
    starts = []
    real = port_faults.fault_point

    def record(site, **ctx):
        if site == "chunked.batch":
            starts.append((ctx["start"], ctx["batch"]))
        real(site, **ctx)

    monkeypatch.setattr(port_chunked, "fault_point", record)
    got = TorchBackend(device="cpu", split_complex=True, slice_batch=4).execute_sliced(
        port["sp"], port["arrays"], ckpt=d)
    assert starts == [(6, 4), (10, 4), (14, 2)]
    assert abs(got - want) <= 1e-5 * abs(want)


@pytest.mark.parametrize("split", [True, False])
def test_chunked_halves_its_batch_on_oom(split):
    want = _chunked(split)
    with port_faults.faults("chunked.batch(start=4)=oom*1"):
        got = _chunked(split)
    assert obs.counters_by_prefix("resilience.degrade") == {
        "resilience.degrade.batch_shrink": 1.0}
    assert port_obs_core.get_registry().gauges()[("resilience.degrade.batch", ())] == 2.0
    g, w = (np.asarray(x) for x in ((got, want) if not split else (got[0], want[0])))
    assert np.allclose(g, w, rtol=1e-5, atol=1e-5 * float(np.max(np.abs(w))))


def test_chunked_oom_at_batch_one_raises():
    port = _sixteen()
    backend = TorchBackend(device="cpu", split_complex=True, slice_batch=1)
    with port_faults.faults("chunked.batch=oom*-1"):
        with pytest.raises(port_faults.InjectedOOM):
            backend.execute_sliced(port["sp"], port["arrays"], max_slices=2)


def test_chunked_retries_a_transient_in_place():
    want = _chunked(True)
    with port_faults.faults("chunked.batch(start=8)=transient*1; chunked.plan=transient*0"):
        got = _chunked(True)
    assert _bits(got) == _bits(want)
    assert obs.counters_by_prefix("resilience.retry.attempts") == {
        "resilience.retry.attempts{site=chunked.batch}": 1.0}


def test_chunked_plan_fault_point():
    import tnc_tpu_torch.ops.chunked as port_chunked

    port_chunked._PLAN_CACHE.clear()
    with port_faults.faults("chunked.plan=fatal*1"):
        with pytest.raises(port_faults.InjectedFatal):
            _chunked(True)
    assert _bits(_chunked(True)) == _bits(_chunked(True))


def test_chunked_capture_fault_retries_the_batch(monkeypatch):
    """A fault inside a capture ends it (the stand-in graph's capture runs
    the closure, as a real one runs the Python) and the batch runs again:
    the graphed result keeps the eager bits."""
    from tests.test_torch_graphs import ReplayedClosure
    import tnc_tpu_torch.ops.chunked as port_chunked
    import tnc_tpu_torch.ops.sliced as port_sliced

    real = port_sliced.kahan_step

    def kahan_step(s, c, x):
        if ReplayedClosure.stepped is not None:
            for t in (s, c):
                ReplayedClosure.stepped.setdefault(id(t), (t, t.clone()))
        real(s, c, x)

    monkeypatch.setattr(port_chunked, "kahan_step", kahan_step)
    eager = _chunked(True, graphs=False)
    monkeypatch.setattr(port_graphs, "graph_class", lambda device: ReplayedClosure)
    port_graphs.reset_stats()
    with port_faults.faults("graphs.capture(unit=chunk 0)=transient*1"):
        got = _chunked(True)
    assert _bits(got) == _bits(eager)
    assert port_graphs.STATS["graphs"] >= 1
    assert obs.counters_by_prefix("resilience.retry.attempts") == {
        "resilience.retry.attempts{site=chunked.batch}": 1.0}
    port_graphs.reset_stats()


# --- TorchBackend's dispatch ---------------------------------------------------


def _program():
    port = _both(SMALL)["port"]
    return build_program(port["tn"], port["path"]), [
        l.data.into_data() for l in flat_leaf_tensors(port["tn"])]


@pytest.mark.parametrize("split", [True, False])
def test_backend_dispatch_retries_a_transient(split):
    program, arrays = _program()
    backend = TorchBackend(device="cpu", split_complex=split)
    want = backend.execute(program, arrays)
    with port_faults.faults("backend.dispatch=transient*2"):
        got = backend.execute(program, arrays)
    assert got.tobytes() == want.tobytes()
    assert obs.counters_by_prefix("resilience.retry.attempts") == {
        "resilience.retry.attempts{site=backend.dispatch}": 2.0}
    with port_faults.faults("backend.dispatch=fatal*1"):
        with pytest.raises(port_faults.InjectedFatal):
            backend.execute(program, arrays)
    with port_faults.faults("backend.dispatch=transient*-1"):
        with pytest.raises(port_retry.RetryExhaustedError):
            backend.execute(program, arrays)


def test_backend_batched_dispatch_retries():
    from tnc_tpu_torch.builders.sycamore_circuit import sycamore_circuit
    from tnc_tpu_torch.serve.rebind import bind_template

    bound = bind_template(sycamore_circuit(12, 4, np.random.default_rng(3))
                          .into_amplitude_template("0" * 12))
    bits = ["0" * 12, "1" * 12, "01" * 6]
    backend = TorchBackend(device="cpu", split_complex=True)
    want = bound.amplitudes(bits, backend)
    with port_faults.faults("backend.dispatch=transient*1"):
        got = bound.amplitudes(bits, backend)
    assert got.tobytes() == want.tobytes()


# --- metrics ----------------------------------------------------------------


def test_quantile_summary_matches_reference():
    values = np.random.default_rng(0).lognormal(size=500)
    port, ref = port_obs_core.QuantileSummary(), ref_obs_core.QuantileSummary()
    for v in values:
        port.observe(float(v))
        ref.observe(float(v))
    assert port.snapshot() == ref.snapshot()


def test_registry_metrics_match_reference():
    regs = (port_obs_core.MetricsRegistry(), ref_obs_core.MetricsRegistry())
    for reg in regs:
        reg.counter_add("serve.requests", 2, kind="amplitude")
        reg.counter_add("serve.requests", 1, kind="sample")
        reg.gauge_set("serve.queue_depth", 3)
        for v in (0.1, 0.3, 0.2):
            reg.observe("serve.latency_s", v, type="amplitude")
    port, ref = (reg.snapshot() for reg in regs)
    assert port == ref


def test_spans_add_counters_and_trace_args():
    with obs.trace_args(riders="r1"):
        with obs.span("serve.dispatch", batch=2) as sp:
            sp.add(flops=10)
            sp.add(flops=5)
    rec = port_obs_core.get_registry().span_records()[-1]
    assert rec.args == {"riders": "r1", "batch": 2, "flops": 15}
    assert port_obs_core.get_registry().counters()[("serve.dispatch.flops", ())] == 15.0
    assert port_obs_core.get_registry().span_stats()["serve.dispatch"]["count"] == 1

    @obs.traced("plan.demo")
    def planned():
        return 3

    assert planned() == 3
    assert port_obs_core.get_registry().span_records()[-1].name == "plan.demo"


@pytest.mark.parametrize("module", [
    port_resilience.retry, port_resilience.faultinject, port_resilience.checkpoint,
    port_obs_core], ids=["retry", "faultinject", "checkpoint", "obs_core"])
def test_doctests(module):
    assert doctest.testmod(module).failed == 0
