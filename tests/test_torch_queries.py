"""The port's marginal sweeps and chain-rule sampler
(``tnc_tpu_torch.queries``) against the JAX package on the CPU.

- ``marginal_sweep`` and ``marginal_probabilities``: bitwise the
  reference's on ``NumpyBackend``, within 1e-5 of max p on
  ``TorchBackend(device="cpu")`` (split and native), summing to the
  marginals of the port's own complex128 statevector within 1e-12; the
  reference's errors for a mask mismatch.
- With no backend they take ``TorchBackend()`` and raise without CUDA.
- ``ChainSampler.sample`` / ``sample_groups`` / ``sample_bitstrings`` draw
  the reference's exact bitstrings for several seeds on ``NumpyBackend``
  (same seed, same conditionals: one uniform vector per position,
  sample-major, prefixes deduplicated in insertion order), and the same
  on ``TorchBackend(device="cpu")``, split and native, whose conditionals
  are within 1e-5 of the reference's; a request's stream does not depend
  on co-riders.

Configurations: ``sycamore_circuit(12, 4)`` and ``(16, 6)`` (rng 42) and a
10-qubit random circuit on a line.
"""

import doctest
import functools

import numpy as np
import pytest

import tnc_tpu_torch.queries.marginal as port_marginal
import tnc_tpu_torch.queries.sampling as port_sampling
from tnc_tpu.builders.connectivity import ConnectivityLayout as RefLayout
from tnc_tpu.builders.random_circuit import random_open_circuit as ref_random
from tnc_tpu.builders.sycamore_circuit import sycamore_circuit as ref_sycamore
from tnc_tpu.ops.backends import NumpyBackend as RefNumpyBackend
from tnc_tpu.queries.marginal import bind_marginal as ref_bind_marginal
from tnc_tpu.queries.marginal import marginal_probabilities as ref_marginal_probabilities
from tnc_tpu.queries.marginal import marginal_sweep as ref_marginal_sweep
from tnc_tpu.queries.sampling import ChainSampler as RefChainSampler
from tnc_tpu.queries.sampling import sample_bitstrings as ref_sample_bitstrings
from tnc_tpu_torch.builders.connectivity import ConnectivityLayout
from tnc_tpu_torch.builders.random_circuit import random_open_circuit
from tnc_tpu_torch.builders.sycamore_circuit import sycamore_circuit
from tnc_tpu_torch.contractionpath.paths import Greedy, OptMethod
from tnc_tpu_torch.ops.backends import NumpyBackend, TorchBackend
from tnc_tpu_torch.queries import (
    ChainSampler,
    bind_marginal,
    marginal_probabilities,
    marginal_sweep,
    sample_bitstrings,
    wildcard_mask,
)
from tnc_tpu_torch.tensornetwork.contraction import contract_tensor_network

CASES = ["syc12m4", "syc16m6", "rand10"]
REL = 1e-5
SEEDS = [0, 1, 7, 123]


def _circuit(case, port=True):
    if case == "rand10":
        build, layout = (random_open_circuit, ConnectivityLayout) if port else (
            ref_random, RefLayout)
        return build(10, 6, 0.5, 0.5, np.random.default_rng(3), layout.LINE)
    q, m = {"syc12m4": (12, 4), "syc16m6": (16, 6)}[case]
    return (sycamore_circuit if port else ref_sycamore)(q, m, np.random.default_rng(42))


def _patterns(n, k, count=8, seed=11):
    rows = np.random.default_rng(seed).integers(0, 2, (count, k))
    return ["".join(str(int(b)) for b in r) + "*" * (n - k) for r in rows]


@functools.lru_cache(maxsize=None)
def _probabilities(case):
    """|amplitude|² of every bitstring, qubit order, from the port's
    complex128 statevector."""
    circuit = _circuit(case)
    n = circuit.num_qubits()
    tn, permutor = circuit.into_statevector_network()
    path = Greedy(OptMethod.GREEDY).find_path(tn).replace_path()
    sv = permutor.apply(contract_tensor_network(tn, path, NumpyBackend())).data.into_data()
    return np.abs(np.asarray(sv).reshape((2,) * n)) ** 2


@pytest.mark.parametrize("module", [port_marginal, port_sampling], ids=["marginal", "sampling"])
def test_doctests(module):
    assert doctest.testmod(module).failed == 0


def test_wildcard_mask():
    for p in ("0*1", "****", "0101", ""):
        from tnc_tpu.queries.marginal import wildcard_mask as ref_mask

        assert wildcard_mask(p) == ref_mask(p)


@pytest.mark.parametrize("k", [1, 4, 8])
@pytest.mark.parametrize("case", CASES)
def test_marginal_sweep_matches_reference(case, k):
    n = _circuit(case).num_qubits()
    patterns = _patterns(n, k)
    want = ref_marginal_sweep(_circuit(case, False), patterns, backend=RefNumpyBackend())
    got = marginal_sweep(_circuit(case), patterns, backend=NumpyBackend())
    assert got.dtype == want.dtype == np.float64
    assert np.array_equal(got, want)
    # against the statevector's marginals
    probs = _probabilities(case)
    oracle = [probs[tuple(int(c) for c in p[:k])].sum() for p in patterns]
    assert np.max(np.abs(got - oracle)) <= 1e-12
    for split in (True, False):
        got32 = marginal_sweep(_circuit(case), patterns,
                               backend=TorchBackend(device="cpu", split_complex=split))
        assert float(np.max(np.abs(got32 - want))) <= REL * float(np.max(want))


def test_marginal_probabilities_matches_reference_and_rejects_other_masks():
    n = 12
    mask = "?" * 5 + "*" * 7
    bound = bind_marginal(_circuit("syc12m4"), mask)
    ref = ref_bind_marginal(_circuit("syc12m4", False), mask)
    assert bound.program.signature_digest() == ref.program.signature_digest()
    patterns = _patterns(n, 5, 6, seed=3)
    got = marginal_probabilities(bound, patterns, NumpyBackend())
    assert np.array_equal(got, ref_marginal_probabilities(ref, patterns))
    assert np.all(got >= 0.0)
    got32 = marginal_probabilities(bound, patterns, TorchBackend(device="cpu"))
    assert float(np.max(np.abs(got32 - got))) <= REL * float(np.max(got))

    def error(fn):
        with pytest.raises(ValueError) as info:
            fn()
        return str(info.value)

    bad = ["01*" + "1" * 9]
    assert error(lambda: marginal_probabilities(bound, bad)) == error(
        lambda: ref_marginal_probabilities(ref, bad))
    mixed = ["0" * 5 + "*" * 7, "0" * 4 + "*" * 8]
    assert error(lambda: marginal_sweep(_circuit("syc12m4"), mixed)) == error(
        lambda: ref_marginal_sweep(_circuit("syc12m4", False), mixed))
    assert marginal_sweep(_circuit("syc12m4"), []).shape == (0,)


class _Recording(ChainSampler):
    """A sampler that keeps every step's prefixes and conditionals."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.steps = []

    def conditionals(self, prefixes, backend=None):
        out = super().conditionals(prefixes, backend)
        self.steps.append((list(prefixes), out))
        return out


@pytest.mark.parametrize("case", CASES)
def test_sampler_draws_the_references_bitstrings(case):
    sampler = ChainSampler(_circuit(case), backend=NumpyBackend())
    ref = RefChainSampler(_circuit(case, False))
    for seed in SEEDS:
        got = sampler.sample(24, seed=seed)
        assert got == ref.sample(24, seed=seed)
        assert len(got) == 24 and all(len(b) == sampler.num_qubits for b in got)
    specs = [(5, 1), (9, 2)]
    groups = sampler.sample_groups(specs)
    assert groups == ref.sample_groups(specs)
    # a request's stream does not depend on its co-riders
    assert groups[0] == sampler.sample(5, seed=1)
    assert groups[1] == sampler.sample(9, seed=2)
    assert sample_bitstrings(_circuit(case), 16, seed=5,
                             backend=NumpyBackend()) == ref_sample_bitstrings(
        _circuit(case, False), 16, seed=5)


@pytest.mark.parametrize("case", CASES)
def test_sampler_conditionals_match_reference(case):
    sampler = _Recording(_circuit(case), backend=NumpyBackend())
    ref = RefChainSampler(_circuit(case, False))
    sampler.sample(32, seed=9)
    steps = list(sampler.steps)
    assert len(steps) == sampler.num_qubits
    for prefixes, probs in steps:
        want = ref.conditionals(prefixes, RefNumpyBackend())
        assert np.array_equal(probs, want)
        for split in (True, False):
            got = ChainSampler.conditionals(
                sampler, prefixes, TorchBackend(device="cpu", split_complex=split))
            assert float(np.max(np.abs(got - want))) <= REL


@pytest.mark.parametrize("split", [True, False], ids=["split", "native"])
@pytest.mark.parametrize("case", CASES)
def test_sampler_on_torch_draws_the_references_bitstrings(case, split):
    backend = TorchBackend(device="cpu", split_complex=split)
    ref = RefChainSampler(_circuit(case, False))
    sampler = ChainSampler(_circuit(case), backend=backend)
    for seed in SEEDS[:2]:
        assert sampler.sample(24, seed=seed) == ref.sample(24, seed=seed)


def test_sampler_marginals_and_errors_match_reference():
    sampler = ChainSampler(_circuit("syc12m4"), backend=NumpyBackend())
    ref = RefChainSampler(_circuit("syc12m4", False))
    for prefixes in (["0101", "1100", "0101"], [""], []):
        assert np.array_equal(sampler.marginals(prefixes), ref.marginals(prefixes))
    for call in (lambda s: s.marginals(["01", "011"]), lambda s: s.sample(0),
                 lambda s: s.sample_groups([(2, 0), (-1, 1)])):
        with pytest.raises(ValueError) as got:
            call(sampler)
        with pytest.raises(ValueError) as want:
            call(ref)
        assert str(got.value) == str(want.value)
    from tnc_tpu.builders.circuit_builder import Circuit as RefCircuit
    from tnc_tpu_torch.builders.circuit_builder import Circuit

    with pytest.raises(ValueError, match="0-qubit"):
        ChainSampler(Circuit())
    with pytest.raises(ValueError, match="0-qubit"):
        RefChainSampler(RefCircuit())


def test_sampler_counts_steps_and_conditionals():
    port_sampling.COUNTS.update(steps=0, conditionals=0)
    sampler = _Recording(_circuit("rand10"), backend=NumpyBackend())
    sampler.sample(16, seed=4)
    assert port_sampling.COUNTS["steps"] == 10
    assert port_sampling.COUNTS["conditionals"] == sum(len(p) for p, _ in sampler.steps)


@pytest.mark.parametrize("entry", ["marginal_sweep", "marginal_probabilities",
                                   "ChainSampler", "sample_bitstrings"])
def test_query_entry_points_without_backend_are_the_card(entry):
    """With no backend the queries take ``TorchBackend()`` (the reference
    takes its complex128 ``NumpyBackend``): they raise without CUDA rather
    than run on the host."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    mask = "?" * 5 + "*" * 5
    patterns = _patterns(10, 5, 2, seed=3)
    calls = {
        "marginal_sweep": lambda: marginal_sweep(_circuit("rand10"), patterns),
        "marginal_probabilities": lambda: marginal_probabilities(
            bind_marginal(_circuit("rand10"), mask), patterns),
        "ChainSampler": lambda: ChainSampler(_circuit("rand10")).sample(4, seed=0),
        "sample_bitstrings": lambda: sample_bitstrings(_circuit("rand10"), 4, seed=0),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()
