"""The port's OOM degradation ladder
(``tnc_tpu_torch.resilience.degrade.execute_sliced_resilient``) against the
JAX package on the CPU.

- Under an injected ``oom`` on ``NumpyBackend`` both packages replan the
  same number of times to the same final slicing and give the same bits
  (the reference's budget model with its TPU lane padding set to 1, the
  port's model); past ``max_replans`` both re-raise.
- The fallback rung: the per-slice loop on ``TorchBackend(device="cpu",
  sliced_strategy="loop")`` falls back to the chunked executor at batch 1
  and agrees with the reference's ``JaxBackend`` fallback to 1e-5; the
  loop is one ``backend.dispatch`` (a fault there reaches the ladder, a
  transient one retries).
- A failed attempt's frames are cleared and collected before the next
  rung runs (what it held is gone), FATAL errors re-raise untouched, and a
  nested path is refused, as in the reference.

Configurations: the all-zeros amplitudes of ``sycamore_circuit(12, 4)``,
``(13, 5)`` and ``(12, 6)`` (rng 42), ``Greedy``, ``find_slicing`` to half
the path's peak (a second replan quarters the target again, too many slices
for the host oracle: each case replans once).
"""

import doctest
import gc
import weakref

import numpy as np
import pytest
import torch

import tnc_tpu.obs as ref_obs
import tnc_tpu.ops.budget as ref_budget
import tnc_tpu.resilience.faultinject as ref_faults
import tnc_tpu.resilience.retry as ref_retry
import tnc_tpu_torch.obs as port_obs
import tnc_tpu_torch.resilience.degrade as port_degrade
import tnc_tpu_torch.resilience.faultinject as port_faults
import tnc_tpu_torch.resilience.retry as port_retry
from tnc_tpu.builders.sycamore_circuit import sycamore_circuit as ref_sycamore
from tnc_tpu.contractionpath.paths import Greedy as RefGreedy
from tnc_tpu.contractionpath.paths import OptMethod as RefOptMethod
from tnc_tpu.contractionpath.slicing import find_slicing as ref_find_slicing
from tnc_tpu.ops.backends import JaxBackend
from tnc_tpu.ops.backends import NumpyBackend as RefNumpyBackend
from tnc_tpu.resilience.degrade import execute_sliced_resilient as ref_resilient
from tnc_tpu_torch.builders.sycamore_circuit import sycamore_circuit
from tnc_tpu_torch.contractionpath.paths import Greedy, OptMethod
from tnc_tpu_torch.contractionpath.slicing import find_slicing
from tnc_tpu_torch.ops.backends import NumpyBackend, TorchBackend
from tnc_tpu_torch.ops.program import flat_leaf_tensors
from tnc_tpu_torch.ops.sliced import build_sliced_program
from tnc_tpu_torch.resilience import execute_sliced_resilient

# the all-zeros amplitudes of these are O(2^-N/2); (14, 5)'s is 0 to roundoff
CASES = [(12, 4), (13, 5)]


@pytest.fixture(autouse=True)
def quick_retries(monkeypatch):
    for mod in (port_retry, ref_retry):
        mod.configure_retry(mod.RetryPolicy(max_attempts=3, base_delay_s=0.0))
    # the reference models a TPU's 128 lanes; the port's budget counts
    # plain elements (ROADMAP, Divergences)
    monkeypatch.setattr(ref_budget, "_LANE", 1)
    yield
    for mod in (port_retry, ref_retry):
        mod.configure_retry(None)


@pytest.fixture
def traced():
    """Both packages recording into fresh registries; restored after."""
    saved = [(obs.enabled(), obs.get_registry()) for obs in (port_obs, ref_obs)]
    port = port_obs.configure(enabled=True, registry=port_obs.MetricsRegistry())
    ref = ref_obs.configure(enabled=True, registry=ref_obs.MetricsRegistry())
    yield port, ref
    for obs, (on, reg) in zip((port_obs, ref_obs), saved):
        obs.configure(enabled=on, registry=reg)


def _network(qubits, depth, port=True):
    """The amplitude network "0"xN, its Greedy path and a slicing at half
    its peak, in one package."""
    build = sycamore_circuit if port else ref_sycamore
    greedy = Greedy(OptMethod.GREEDY) if port else RefGreedy(RefOptMethod.GREEDY)
    slicer = find_slicing if port else ref_find_slicing
    tn, _ = build(qubits, depth, np.random.default_rng(42)).into_amplitude_network(
        "0" * qubits)
    res = greedy.find_path(tn)
    path = res.replace_path()
    slicing = slicer(tn.tensors, path.toplevel, max(res.size / 2.0, 4.0))
    return tn, path, slicing


def _arrays(tn):
    return [np.asarray(leaf.data.into_data()) for leaf in flat_leaf_tensors(tn)]


def _ladder_counts(reg):
    return {name: value for (name, _), value in reg.counters().items()
            if name.startswith("resilience.ladder")}


@pytest.mark.parametrize("qubits, depth, oom", [
    (12, 4, "sliced.slice=oom*1"), (13, 5, "sliced.slice=oom*1"),
    (12, 6, "sliced.slice(s=3)=oom*1"), (13, 5, "sliced.slice(s=1)=oom*1")])
def test_numpy_replans_match_reference(traced, qubits, depth, oom):
    port_reg, ref_reg = traced
    tn, path, slicing = _network(qubits, depth)
    rtn, rpath, rslicing = _network(qubits, depth, port=False)
    assert (slicing.legs, slicing.dims) == (tuple(rslicing.legs), tuple(rslicing.dims))
    with port_faults.faults(oom):
        out, used = execute_sliced_resilient(tn, path, slicing, backend=NumpyBackend())
    with ref_faults.faults(oom):
        want, rused = ref_resilient(rtn, rpath, rslicing, backend=RefNumpyBackend())
    assert (tuple(used.legs), tuple(used.dims)) == (tuple(rused.legs), tuple(rused.dims))
    assert (used.legs, used.dims) != (slicing.legs, slicing.dims)
    assert np.asarray(out).tobytes() == np.asarray(want).tobytes()
    assert _ladder_counts(port_reg) == _ladder_counts(ref_reg)
    assert _ladder_counts(port_reg)["resilience.ladder.replans"] == 1.0


@pytest.mark.parametrize("qubits, depth", CASES)
def test_exhausted_replans_reraise_as_the_reference(qubits, depth):
    tn, path, slicing = _network(qubits, depth)
    rtn, rpath, rslicing = _network(qubits, depth, port=False)
    with port_faults.faults("sliced.slice=oom*9"), pytest.raises(port_faults.InjectedOOM):
        execute_sliced_resilient(tn, path, slicing, backend=NumpyBackend(), max_replans=1)
    with ref_faults.faults("sliced.slice=oom*9"), pytest.raises(ref_faults.InjectedOOM):
        ref_resilient(rtn, rpath, rslicing, backend=RefNumpyBackend(), max_replans=1)


@pytest.mark.parametrize("qubits, depth", CASES)
@pytest.mark.parametrize("split", [False, True], ids=["native", "split"])
def test_fallback_rung_matches_reference(traced, qubits, depth, split, monkeypatch):
    """The loop raises RESOURCE once with no replans left: both packages run
    the chunked executor at batch 1 on the same slicing."""
    port_reg, ref_reg = traced
    tn, path, slicing = _network(qubits, depth)
    rtn, rpath, rslicing = _network(qubits, depth, port=False)
    backend = TorchBackend(device="cpu", sliced_strategy="loop", split_complex=split)
    with port_faults.faults("backend.dispatch=oom*1"):
        out, used = execute_sliced_resilient(tn, path, slicing, backend=backend,
                                             max_replans=0)
    ref_backend = JaxBackend(dtype="complex64", sliced_strategy="loop", split_complex=split)
    real = ref_backend.execute_sliced
    calls = []

    def once(*args, **kwargs):  # the reference's loop has no fault point
        calls.append(1)
        if len(calls) == 1:
            raise ref_faults.InjectedOOM("RESOURCE_EXHAUSTED: injected out of memory")
        return real(*args, **kwargs)

    monkeypatch.setattr(ref_backend, "execute_sliced", once)
    want, rused = ref_resilient(rtn, rpath, rslicing, backend=ref_backend, max_replans=0)
    assert used == slicing and tuple(rused.legs) == tuple(slicing.legs)
    got, want = np.asarray(out).reshape(-1)[0], np.asarray(want).reshape(-1)[0]
    assert abs(got - want) <= 1e-5 * abs(want)
    oracle = NumpyBackend().execute_sliced(build_sliced_program(tn, path, slicing),
                                           _arrays(tn))
    assert abs(got - oracle.reshape(-1)[0]) <= 1e-5 * abs(oracle.reshape(-1)[0])
    assert _ladder_counts(port_reg) == _ladder_counts(ref_reg) == {
        "resilience.ladder.fallback_chunked": 1.0}


def test_loop_is_one_retryable_dispatch(traced):
    port_reg, _ = traced
    tn, path, slicing = _network(12, 4)
    sp = build_sliced_program(tn, path, slicing)
    arrays = _arrays(tn)
    loop = TorchBackend(device="cpu", sliced_strategy="loop")
    clean = loop.execute_sliced(sp, arrays)
    with port_faults.faults("backend.dispatch=transient*2"):
        again = loop.execute_sliced(sp, arrays)
    assert again.tobytes() == clean.tobytes()
    assert port_reg.counters()[("resilience.retry.attempts",
                                (("site", "backend.dispatch"),))] == 2.0


def test_failed_attempt_is_released_before_the_next_rung():
    """What the failed attempt's frames held is collected before the
    ladder's next attempt starts."""
    tn, path, slicing = _network(12, 4)
    held = []
    seen_alive = []

    class Backend(NumpyBackend):
        def execute_sliced(self, sp, arrays, **kwargs):
            if not held:
                big = torch.zeros(1 << 16)
                held.append(weakref.ref(big))
                cycle = [big]
                cycle.append(cycle)  # reachable only through a cycle once freed
                raise torch.cuda.OutOfMemoryError("CUDA out of memory (test)")
            seen_alive.append(held[0]() is not None)
            return super().execute_sliced(sp, arrays, **kwargs)

    gc.disable()
    try:
        out, used = execute_sliced_resilient(tn, path, slicing, backend=Backend())
    finally:
        gc.enable()
    assert seen_alive == [False]
    want = NumpyBackend().execute_sliced(build_sliced_program(tn, path, slicing), _arrays(tn))
    assert (used.legs, used.dims) != (slicing.legs, slicing.dims)
    assert np.allclose(out, want, rtol=1e-10, atol=0)


def test_fatal_reraises_untouched():
    tn, path, slicing = _network(12, 4)
    with port_faults.faults("sliced.slice=fatal*1"), pytest.raises(port_faults.InjectedFatal):
        execute_sliced_resilient(tn, path, slicing, backend=NumpyBackend())
    # a sticky CUDA error is FATAL too: never retried, never replanned
    calls = []

    class Sticky(NumpyBackend):
        def execute_sliced(self, *a, **k):
            calls.append(1)
            raise RuntimeError("CUDA error: an illegal memory access was encountered")

    with pytest.raises(RuntimeError, match="illegal memory access"):
        execute_sliced_resilient(tn, path, slicing, backend=Sticky())
    assert calls == [1]


def test_chunked_strategy_out_of_replans_reraises():
    tn, path, slicing = _network(12, 4)
    backend = TorchBackend(device="cpu", sliced_strategy="chunked", slice_batch=1)
    with port_faults.faults("chunked.batch=oom*99"), pytest.raises(port_faults.InjectedOOM):
        execute_sliced_resilient(tn, path, slicing, backend=backend, max_replans=1)


def test_nested_path_refused():
    from tnc_tpu_torch.contractionpath.contraction_path import ContractionPath

    tn, path, slicing = _network(12, 4)
    nested = ContractionPath({0: ContractionPath.simple([(0, 1)])}, list(path.toplevel))
    with pytest.raises(ValueError, match="flat path"):
        execute_sliced_resilient(tn, nested, slicing, backend=NumpyBackend())


def test_default_backend_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the CUDA-less host")
    tn, path, slicing = _network(12, 4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        execute_sliced_resilient(tn, path, slicing)


def test_doctests():
    assert doctest.testmod(port_degrade).failed == 0
