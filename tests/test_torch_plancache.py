"""The port's plan cache and cross-request reuse
(``tnc_tpu_torch.serve.plancache``, ``tnc_tpu_torch.serve.reuse`` and the
``plan_cache`` / ``reuse_store`` branches of ``bind_template``) against the
JAX package on the CPU.

- ``network_structure_digest`` keys and ``PlanCache.record_for`` records
  equal the reference's for the same circuit (plain and sliced); an entry
  either package writes is a hit in the other, with no pathfinding; a
  corrupt or drifted entry is dropped and replanned.
- ``bind_expectation(plan_cache=)``, ``bind_marginal`` and the sampler
  plan through the cache.
- ``compute_split`` gives the reference's residual, node digests, cached
  nodes and sources; reused amplitudes bit-compare to cold ones and to
  the reference's on ``NumpyBackend`` (plain and sliced), agree with cold
  ones within 1e-5 on ``TorchBackend(device="cpu")``; the store's tiers,
  admission and environment keys (a ``TorchBackend``'s carries its split
  mode, precision, device and kernel policy key).

Configurations: ``sycamore_circuit(12, 4)`` (rng 42) and a 10-qubit
random circuit on a line.
"""

import doctest
import json

import numpy as np
import pytest

import tnc_tpu.serve.rebind as ref_rebind
import tnc_tpu_torch.serve.plancache as port_plancache
import tnc_tpu_torch.serve.rebind as port_rebind
import tnc_tpu_torch.serve.reuse as port_reuse
from tnc_tpu.builders.sycamore_circuit import sycamore_circuit as ref_sycamore
from tnc_tpu.ops.backends import NumpyBackend as RefNumpyBackend
from tnc_tpu.queries.expectation import bind_expectation as ref_bind_expectation
from tnc_tpu.serve.plancache import PlanCache as RefPlanCache
from tnc_tpu.serve.plancache import network_structure_digest as ref_digest
from tnc_tpu.serve.reuse import IntermediateStore as RefStore
from tnc_tpu.serve.reuse import backend_env_key as ref_env_key
from tnc_tpu.serve.reuse import compute_split as ref_compute_split
from tnc_tpu_torch.builders.sycamore_circuit import sycamore_circuit
from tnc_tpu_torch.obs.calibrate import CalibratedCostModel
from tnc_tpu_torch.ops.backends import NumpyBackend, TorchBackend
from tnc_tpu_torch.ops.program import flat_leaf_tensors
from tnc_tpu_torch.queries import ChainSampler, bind_expectation, bind_marginal
from tnc_tpu_torch.serve import (
    IntermediateStore,
    PlanCache,
    bind_template,
    compute_split,
    network_structure_digest,
    plan_signature,
)
from tnc_tpu_torch.serve.reuse import backend_env_key, store_key

Q, M = 12, 4
# a peak near the plan's own (80 elements at sycamore_circuit(12, 4)) keeps
# the slice count small
SLICED_TARGET = 40.0
BITS = ["0" * Q, "1" * Q, "01" * 6, "110100101101", "000111000111"]


def _circuit(port=True, seed=42):
    return (sycamore_circuit if port else ref_sycamore)(Q, M, np.random.default_rng(seed))


def _template(port=True, mask=None, seed=42):
    return _circuit(port, seed).into_amplitude_template(mask or "0" * Q)


def _no_planner(monkeypatch):
    """Any pathfinding in the port fails the test."""
    def refuse(*a, **k):
        raise AssertionError("the planner ran on a cache hit")

    monkeypatch.setattr(port_rebind, "plan_structure", refuse)


# --- keys and records -----------------------------------------------------


@pytest.mark.parametrize("target", [None, SLICED_TARGET, 2.0 ** 20])
def test_structure_digest_matches_reference(target):
    port, ref = _template(), _template(False)
    assert network_structure_digest(port.network, target) == ref_digest(ref.network, target)


def test_digest_is_bitstring_independent_and_budget_keyed():
    a = _circuit().into_amplitude_network("0" * Q)[0]
    b = _circuit().into_amplitude_network("1" * Q)[0]
    assert network_structure_digest(a) == network_structure_digest(b)
    assert network_structure_digest(a) != network_structure_digest(a, 1e6)


@pytest.mark.parametrize("target", [None, SLICED_TARGET])
def test_records_match_reference(tmp_path, target):
    port_cache, ref_cache = PlanCache(tmp_path / "p"), RefPlanCache(tmp_path / "r")
    bound = bind_template(_template(), plan_cache=port_cache, target_size=target)
    ref = ref_rebind.bind_template(_template(False), plan_cache=ref_cache,
                                   target_size=target)
    drop = ("created_at",)
    got = {k: v for k, v in bound.plan.items() if k not in drop}
    want = {k: v for k, v in ref.plan.items() if k not in drop}
    assert got == want
    assert (bound.sliced is not None) == (target is not None) == ("sliced_sig" in got)
    key = port_cache.key_for_network(_template().network, target)
    assert json.loads((tmp_path / "p" / f"{key}.json").read_text())["pairs"] == want["pairs"]


@pytest.mark.parametrize("writer", ["reference", "port"])
@pytest.mark.parametrize("target", [None, SLICED_TARGET])
def test_entries_interchange_with_reference(tmp_path, monkeypatch, writer, target):
    """An entry either package writes answers the other's lookup: no
    pathfinding, the same program signature, the same amplitudes."""
    if writer == "reference":
        ref_rebind.bind_template(_template(False), plan_cache=RefPlanCache(tmp_path),
                                 target_size=target)
        cache = PlanCache(tmp_path)
        with monkeypatch.context() as m:
            _no_planner(m)
            bound = bind_template(_template(), plan_cache=cache, target_size=target)
        assert cache.stats()["counts"]["hit"] == 1
        cold = bind_template(_template(), target_size=target)
    else:
        bind_template(_template(), plan_cache=PlanCache(tmp_path), target_size=target)
        cache = RefPlanCache(tmp_path)
        with monkeypatch.context() as m:
            m.setattr(ref_rebind, "plan_structure",
                      lambda *a, **k: pytest.fail("the reference planned"))
            bound = ref_rebind.bind_template(_template(False), plan_cache=cache,
                                             target_size=target)
        assert cache.stats()["counts"]["hit"] == 1
        cold = ref_rebind.bind_template(_template(False), target_size=target)
    assert bound.program.signature_digest() == cold.program.signature_digest()
    backend = NumpyBackend() if writer == "reference" else RefNumpyBackend()
    assert bound.amplitudes(BITS, backend).tobytes() == cold.amplitudes(BITS, backend).tobytes()


def test_warm_bind_does_not_plan(tmp_path, monkeypatch):
    cache = PlanCache(tmp_path)
    first = bind_template(_template(), plan_cache=cache)
    _no_planner(monkeypatch)
    second = bind_template(_template(), plan_cache=cache)
    assert plan_signature(second) == plan_signature(first)
    assert cache.stats()["counts"] == {
        "hit": 1, "miss": 1, "store": 1, "evicted": 0, "corrupt": 0,
        "invalidated": 0, "store_failed": 0}
    assert cache.hits(cache.key_for_network(_template().network)) == 1


@pytest.mark.parametrize("damage", ["garbage", "bad_pairs", "drifted_sig", "wrong_version"])
def test_bad_entries_replan(tmp_path, damage):
    cache = PlanCache(tmp_path)
    want = bind_template(_template())
    bind_template(_template(), plan_cache=cache)
    key = cache.key_for_network(_template().network)
    path = tmp_path / f"{key}.json"
    plan = json.loads(path.read_text())
    if damage == "garbage":
        path.write_text("{not json")
    elif damage == "bad_pairs":
        plan["pairs"] = [[0, 999]]
        path.write_text(json.dumps(plan))
    elif damage == "drifted_sig":
        plan["program_sig"] = "0" * 64
        path.write_text(json.dumps(plan))
    else:
        plan["version"] = 99
        path.write_text(json.dumps(plan))
    got = bind_template(_template(), plan_cache=cache)
    assert got.amplitudes(BITS, NumpyBackend()).tobytes() == \
        want.amplitudes(BITS, NumpyBackend()).tobytes()
    counts = cache.stats()["counts"]
    assert counts["store"] == 2
    assert counts["corrupt" if damage in ("garbage", "wrong_version") else "invalidated"] == 1
    assert json.loads(path.read_text())["program_sig"] == want.program.signature_digest()


def test_lru_eviction_and_hot_keys(tmp_path):
    cache = PlanCache(tmp_path, max_entries=2)
    for k in ("a", "b", "c"):
        cache.store(k, {"version": 1, "pairs": []})
    assert len(cache) == 2 and cache.stats()["counts"]["evicted"] == 1
    assert cache.load("c") is not None and cache.hot_keys() == ["c"]
    assert cache.entry_fingerprint("c") is not None and cache.entry_fingerprint("zz") is None


def test_query_structures_plan_through_the_cache(tmp_path, monkeypatch):
    cache = PlanCache(tmp_path)
    prog = bind_expectation(_circuit(), plan_cache=cache)
    ref = ref_bind_expectation(_circuit(False), plan_cache=RefPlanCache(tmp_path / "r"))
    assert prog.bound.plan["program_sig"] == ref.bound.plan["program_sig"]
    marginal = bind_marginal(_circuit(), "?" * 4 + "*" * (Q - 4), plan_cache=cache)
    sampler = ChainSampler(_circuit(), plan_cache=cache, backend=NumpyBackend())
    samples = sampler.sample(4, seed=3)
    _no_planner(monkeypatch)
    again = bind_expectation(_circuit(), plan_cache=cache)
    assert again.values(["z" + "i" * (Q - 1)], NumpyBackend()).tobytes() == \
        prog.values(["z" + "i" * (Q - 1)], NumpyBackend()).tobytes()
    bind_marginal(_circuit(), "?" * 4 + "*" * (Q - 4), plan_cache=cache)
    assert ChainSampler(_circuit(), plan_cache=cache, backend=NumpyBackend()).sample(
        4, seed=3) == samples
    assert marginal.plan and cache.stats()["counts"]["hit"] >= 2 + Q


# --- reuse ------------------------------------------------------------------


def _split_parts(split):
    return (split.residual.signature_digest(), split.node_digest, split.cached_idx,
            split.sources, split.bra_slots, split.eval_order, split.prefix_flops,
            split.residual_flops)


@pytest.mark.parametrize("target", [None, SLICED_TARGET])
def test_compute_split_matches_reference(target):
    port = bind_template(_template(), target_size=target)
    ref = ref_rebind.bind_template(_template(False), target_size=target)
    got = compute_split(port.program, port.arrays, port.bra_slots, sliced=port.sliced)
    want = ref_compute_split(ref.program, ref.arrays, ref.bra_slots, sliced=ref.sliced)
    assert got is not None and _split_parts(got) == _split_parts(want)
    if target is not None:
        assert got.residual_sliced.slot_slices == want.residual_sliced.slot_slices


def test_trivial_splits_are_none():
    bound = bind_template(_template())
    assert compute_split(bound.program, bound.arrays, ()) is None
    every = tuple(range(bound.program.num_inputs))
    assert compute_split(bound.program, bound.arrays, every) is None


@pytest.mark.parametrize("target", [None, SLICED_TARGET])
def test_reused_amplitudes_bit_compare_to_cold(target):
    """On the numpy backend: the reused binding's amplitudes equal the
    cold binding's and the reference's reused binding's, bit for bit; a
    second binding over the same store hits every cached node."""
    store = IntermediateStore()
    cold = bind_template(_template(), target_size=target)
    reused = bind_template(_template(), target_size=target, reuse_store=store)
    assert reused.reuse is not None and plan_signature(reused) == plan_signature(cold)
    want = cold.amplitudes(BITS, NumpyBackend())
    got = reused.amplitudes(BITS, NumpyBackend())
    ref = ref_rebind.bind_template(_template(False), target_size=target,
                                   reuse_store=RefStore())
    assert got.tobytes() == want.tobytes() == ref.amplitudes(BITS, RefNumpyBackend()).tobytes()
    stored = store.stats()["store"]
    again = bind_template(_template(), target_size=target, reuse_store=store)
    assert again.amplitudes(BITS, NumpyBackend()).tobytes() == want.tobytes()
    stats = store.stats()
    assert stats["store"] == stored and stats["hit"] >= len(reused.reuse.split.cached_idx)


@pytest.mark.parametrize("split", [True, False])
def test_reused_amplitudes_on_torch_cpu(split):
    backend = TorchBackend(device="cpu", split_complex=split)
    cold = bind_template(_template()).amplitudes(BITS, backend)
    got = bind_template(_template(), reuse_store=IntermediateStore()).amplitudes(BITS, backend)
    assert np.allclose(got, cold, rtol=0, atol=1e-5 * float(np.max(np.abs(cold))))


def test_store_tiers_and_corruption(tmp_path):
    store = IntermediateStore(directory=tmp_path, max_bytes=64)
    a, b = np.arange(4, dtype=np.complex128), np.ones(4, dtype=np.complex128)
    store.put("a", a)
    store.put("b", b)  # evicts "a" from memory (64 bytes each)
    assert len(store) == 1 and store.stats()["evicted"] == 1
    assert store.get("a").tobytes() == a.tobytes()  # back from disk
    store.clear_memory()
    (tmp_path / "b.npz").write_bytes(b"torn")
    assert store.get("b") is None and store.stats()["corrupt"] == 1
    assert not (tmp_path / "b.npz").exists()


@pytest.mark.parametrize("flops,nbytes,steps,out", [
    (1e9, 1e6, 10, 1e3), (1e3, 1e6, 1, 1e8), (0.0, 0.0, 1, 16.0)])
def test_admission_matches_reference(flops, nbytes, steps, out):
    from tnc_tpu.obs.calibrate import CalibratedCostModel as RefModel

    port = IntermediateStore(cost_model=CalibratedCostModel(1e12, 1e-5, 1e11))
    ref = RefStore(cost_model=RefModel(1e12, 1e-5, 1e11))
    assert port.admit(flops, nbytes, steps, out) == ref.admit(flops, nbytes, steps, out)
    assert IntermediateStore(min_flops=10.0).admit(flops, nbytes) == (flops >= 10.0)


def test_environment_keys(monkeypatch):
    assert backend_env_key(NumpyBackend()) == ref_env_key(RefNumpyBackend())
    split = TorchBackend(device="cpu", split_complex=True)
    native = TorchBackend(device="cpu", split_complex=False)
    key = backend_env_key(split)
    assert key[:5] == ("torch", "complex64", True, "float32", "cpu")
    assert key != backend_env_key(native)
    assert key != backend_env_key(TorchBackend(device="cpu", split_complex=True,
                                               precision="high"))
    monkeypatch.setenv("TNC_TPU_COMPLEX_MULT", "gauss")
    assert backend_env_key(split) != key
    assert store_key(key, "node") != store_key(backend_env_key(native), "node")


def _synthetic_spans(registry, constants=(1e12, 2e-5, 1e11), n=32, seed=3):
    """Step spans of executor ``torch`` whose fit gives ``constants``
    (flops/s, launch s, bytes/s)."""
    from tnc_tpu_torch.obs import core as port_core

    flops_per_s, dispatch_s, bytes_per_s = constants
    rng = np.random.default_rng(seed)
    for i in range(n):
        flops, nbytes = float(rng.uniform(1e6, 1e10)), float(rng.uniform(1e5, 1e9))
        dur = flops / flops_per_s + nbytes / bytes_per_s + dispatch_s
        registry._spans.append(port_core.SpanRecord(
            f"step[{i}] synthetic", 0, int(round(dur * 1e9)), 1, 1, "main", 0,
            {"executor": "torch", "flops": flops, "bytes_in": nbytes, "bytes_out": 0.0}))


def test_environment_key_is_the_fit_the_policy_used(monkeypatch):
    """A backend keys the store by the cost model its policies were planned
    from: step spans the registry gains between two dispatches change
    neither its key nor the store, and a fresh backend over those spans
    plans, and keys, from their fit."""
    from tnc_tpu_torch import obs
    from tnc_tpu_torch.obs import core as port_core

    for name in ("_ENABLED", "_STEP_TIME", "_REGISTRY"):
        monkeypatch.setattr(port_core, name, getattr(port_core, name))
    monkeypatch.delenv("TNC_TPU_COMPLEX_MULT", raising=False)
    monkeypatch.delenv("TNC_TPU_DOT_PRECISION", raising=False)
    registry = obs.configure(enabled=False, registry=obs.MetricsRegistry(), step_time=False)
    backend = TorchBackend(device="cpu", split_complex=True)
    store = IntermediateStore()
    bound = bind_template(_template(), reuse_store=store)
    first = bound.amplitudes(BITS, backend)
    key = backend_env_key(backend)
    assert key[-1][-1] is None  # planned before any span: the no-model ladder
    stored = store.stats()["store"]

    _synthetic_spans(registry)
    model = CalibratedCostModel.from_registry()
    assert model is not None
    again = bound.amplitudes(BITS, backend)
    assert backend_env_key(backend) == key
    assert again.tobytes() == first.tobytes()
    assert store.stats()["store"] == stored

    fresh = TorchBackend(device="cpu", split_complex=True)
    fitted = backend_env_key(fresh)
    assert fitted[-1][-1] == (model.flops_per_s, model.dispatch_s, model.bytes_per_s)
    assert fitted != key and fresh.cost_model() is fresh.cost_model()


@pytest.mark.parametrize("module", [port_plancache, port_reuse], ids=["plancache", "reuse"])
def test_doctests(module):
    assert doctest.testmod(module).failed == 0
