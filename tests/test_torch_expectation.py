"""The port's expectation-value path against the JAX package on the CPU:
the builders it needs (``Circuit.into_expectation_value_network``,
``qaoa_circuit``, ``brickwork_circuit`` / ``brickwork_from_angles``), the
dense oracle ``queries.statevector`` and ``queries.expectation``.

- Builders: bitwise the reference's leaves (legs, dims, data) — QAOA at
  seeds 0 and 42 on the line and Sycamore layouts — and the reference's
  validation messages.
- ``statevector``: every function bitwise the reference's.
- ``ExpectationProgram.values`` / ``pauli_sum``: bitwise the reference's
  on ``NumpyBackend``; within 1e-5 on ``TorchBackend(device="cpu")``,
  split and native; ``DISPATCH`` counts ``batched`` and ``sliced``; a
  second ``bind_expectation`` over a ``plan_cache`` is a hit.
- ``pauli_expectation_value_and_grad``: within 1e-10 (complex128) of the
  reference's values and cotangents, the θ chain rule over both layers
  against a central difference of the dense oracle, and a batched Pauli
  sum against its singletons.
"""

import doctest
import functools
import math

import numpy as np
import pytest

import tnc_tpu.queries.statevector as ref_sv
import tnc_tpu_torch.queries.expectation as port_expectation
import tnc_tpu_torch.queries.statevector as port_sv
from tnc_tpu.builders.circuit_builder import Circuit as RefCircuit
from tnc_tpu.builders.connectivity import ConnectivityLayout as RefLayout
from tnc_tpu.builders.qaoa_circuit import qaoa_circuit as ref_qaoa
from tnc_tpu.builders.random_circuit import brickwork_circuit as ref_brickwork
from tnc_tpu.builders.random_circuit import brickwork_from_angles as ref_brickwork_angles
from tnc_tpu.ops.backends import NumpyBackend as RefNumpyBackend
from tnc_tpu.ops.program import flat_leaf_tensors as ref_flat
from tnc_tpu.queries.expectation import bind_expectation as ref_bind_expectation
from tnc_tpu.queries.expectation import normalize_terms as ref_normalize_terms
from tnc_tpu.queries.expectation import (
    pauli_expectation_value_and_grad as ref_value_and_grad,
)
from tnc_tpu.queries.expectation import stacked_observables as ref_stacked
from tnc_tpu.tensornetwork.tensordata import TensorData as RefTensorData
from tnc_tpu_torch.builders.circuit_builder import Circuit
from tnc_tpu_torch.builders.connectivity import ConnectivityLayout
from tnc_tpu_torch.builders.qaoa_circuit import qaoa_circuit
from tnc_tpu_torch.builders.random_circuit import brickwork_circuit, brickwork_from_angles
from tnc_tpu_torch.ops.backends import NumpyBackend, TorchBackend
from tnc_tpu_torch.ops.program import flat_leaf_tensors
from tnc_tpu_torch.queries import (
    bind_expectation,
    pauli_expectation,
    pauli_expectation_value_and_grad,
    pauli_sum_expectation,
)
from tnc_tpu_torch.queries.expectation import (
    DISPATCH,
    normalize_terms,
    reset_dispatch,
    stacked_observables,
)
from tnc_tpu_torch.tensornetwork.tensordata import TensorData

REL = 1e-5


def _same_leaves(leaves, ref_leaves):
    assert len(leaves) == len(ref_leaves)
    for a, b in zip(leaves, ref_leaves):
        assert list(a.legs) == list(b.legs)
        assert list(a.bond_dims) == list(b.bond_dims)
        x, y = np.asarray(a.data.into_data()), np.asarray(b.data.into_data())
        assert x.dtype == y.dtype and np.array_equal(x, y)


def _rotations(port: bool, n: int = 3, depth: int = 2, seed: int = 5):
    """The reference tests' generic parameterized circuit (rx/ry/rz + a cx
    brick), built on one side."""
    rng = np.random.default_rng(seed)
    c = (Circuit if port else RefCircuit)()
    data = TensorData if port else RefTensorData
    reg = c.allocate_register(n)
    names = ["rx", "ry", "rz"]
    for layer in range(depth):
        for q in range(n):
            name = names[int(rng.integers(len(names)))]
            c.append_gate(data.gate(name, (float(rng.uniform(0, 2 * math.pi)),)),
                          [reg.qubit(q)])
        for q in range(layer % 2, n - 1, 2):
            c.append_gate(data.gate("cx"), [reg.qubit(q), reg.qubit(q + 1)])
    return c


def _message(fn, exc=ValueError) -> str:
    with pytest.raises(exc) as info:
        fn()
    return str(info.value)


@pytest.mark.parametrize("module", [port_sv, port_expectation], ids=["statevector", "expectation"])
def test_doctests(module):
    assert doctest.testmod(module).failed == 0


@pytest.mark.parametrize("observables", [None, "zxiy"])
def test_expectation_network_matches_reference(observables):
    tn = _rotations(True, 4, 3).into_expectation_value_network(observables)
    ref = _rotations(False, 4, 3).into_expectation_value_network(observables)
    _same_leaves(flat_leaf_tensors(tn), ref_flat(ref))


@pytest.mark.parametrize("bad", ["zz", "zzaz"], ids=["length", "character"])
def test_expectation_network_errors_match_reference(bad):
    assert _message(lambda: _rotations(True, 4).into_expectation_value_network(bad)) == (
        _message(lambda: _rotations(False, 4).into_expectation_value_network(bad)))


@pytest.mark.parametrize("layout", ["LINE", "SYCAMORE"])
@pytest.mark.parametrize("seed", [0, 42])
def test_qaoa_matches_reference(seed, layout):
    c = qaoa_circuit(8, 2, np.random.default_rng(seed), getattr(ConnectivityLayout, layout))
    ref = ref_qaoa(8, 2, np.random.default_rng(seed), getattr(RefLayout, layout))
    _same_leaves(c.tensor_network.tensors, ref.tensor_network.tensors)
    _same_leaves(flat_leaf_tensors(c.into_expectation_value_network()),
                 ref_flat(ref.into_expectation_value_network()))


def test_brickwork_matches_reference():
    c = brickwork_circuit(6, 4, np.random.default_rng(3))
    ref = ref_brickwork(6, 4, np.random.default_rng(3))
    _same_leaves(c.tensor_network.tensors, ref.tensor_network.tensors)
    angles = [[0.1 * (q + 1) + d for q in range(5)] for d in range(3)]
    _same_leaves(brickwork_from_angles(5, angles).tensor_network.tensors,
                 ref_brickwork_angles(5, angles).tensor_network.tensors)


def test_statevector_functions_match_reference():
    port_state = port_sv.statevector(_rotations(True, 4, 3))
    state = ref_sv.statevector(_rotations(False, 4, 3))
    assert port_state.dtype == state.dtype and np.array_equal(port_state, state)
    for bits in ("0000", "1011", [1, 0, None, 1][:2] + [1, 1]):
        assert port_sv.amplitude(state, bits) == ref_sv.amplitude(state, bits)
    for pattern in ("0*1*", "****", "1101"):
        assert port_sv.marginal_probability(state, pattern) == ref_sv.marginal_probability(
            state, pattern)
    for prefix in ("", "1", "010"):
        assert port_sv.conditional_distribution(state, prefix) == (
            ref_sv.conditional_distribution(state, prefix))
    for pauli in ("zxiy", "iiii", "yyzx"):
        assert np.array_equal(port_sv.apply_paulis(state, pauli),
                              ref_sv.apply_paulis(state, pauli))
        assert port_sv.pauli_expectation(state, pauli) == ref_sv.pauli_expectation(state, pauli)
        assert np.array_equal(port_sv.pauli_string_matrix(pauli),
                              ref_sv.pauli_string_matrix(pauli))
    assert port_sv.sample_oracle(state, 12, np.random.default_rng(4)) == ref_sv.sample_oracle(
        state, 12, np.random.default_rng(4))
    assert np.array_equal(port_sv.probabilities(state), ref_sv.probabilities(state))
    assert port_sv.normalize_pauli("IXzY", 4) == ref_sv.normalize_pauli("IXzY", 4)
    for bad in ("ixz", "ixzq"):
        assert _message(lambda: port_sv.normalize_pauli(bad, 4)) == _message(
            lambda: ref_sv.normalize_pauli(bad, 4))
    assert _message(lambda: port_sv.amplitude(state, "01*1")) == _message(
        lambda: ref_sv.amplitude(state, "01*1"))
    assert _message(lambda: port_sv.conditional_distribution(state, "0101")) == _message(
        lambda: ref_sv.conditional_distribution(state, "0101"))
    finalized = _rotations(True, 2)
    finalized.into_expectation_value_network()
    ref_finalized = _rotations(False, 2)
    ref_finalized.into_expectation_value_network()
    assert _message(lambda: port_sv.statevector(finalized)) == _message(
        lambda: ref_sv.statevector(ref_finalized))


def test_stacked_observables_and_terms_match_reference():
    paulis = ["zxiy", "iiii", "yzzx"]
    got, want = stacked_observables(paulis), ref_stacked(paulis)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    for terms in ("ZX", [(0.5, "zi"), (-1j, "XY")]):
        assert normalize_terms(terms, 2) == ref_normalize_terms(terms, 2)
    assert _message(lambda: normalize_terms([], 2)) == _message(
        lambda: ref_normalize_terms([], 2))


TERMS = [(0.5, "zzi"), (-1.25, "xxi"), (2.0, "iyy"), (0.75, "iii")]


def test_values_and_pauli_sum_match_reference():
    paulis = [p for _, p in TERMS]
    prog = bind_expectation(_rotations(True))
    ref = ref_bind_expectation(_rotations(False))
    assert prog.bound.program.signature_digest() == ref.bound.program.signature_digest()
    reset_dispatch()
    got = prog.values(paulis, NumpyBackend())
    want = ref.values(paulis, RefNumpyBackend())
    assert DISPATCH == {"batched": 1}
    assert got.dtype == want.dtype == np.complex128 and np.array_equal(got, want)
    total, vals = prog.pauli_sum(TERMS, NumpyBackend())
    ref_total, ref_vals = ref.pauli_sum(TERMS, RefNumpyBackend())
    assert total == ref_total and np.array_equal(vals, ref_vals)
    state = port_sv.statevector(_rotations(True))
    dense = [port_sv.pauli_expectation(state, p) for p in paulis]
    assert np.max(np.abs(got - dense)) <= 1e-12
    for split in (True, False):
        got32 = prog.values(paulis, TorchBackend(device="cpu", split_complex=split))
        assert float(np.max(np.abs(got32 - want))) <= REL * float(np.max(np.abs(want)))
    assert DISPATCH == {"batched": 4}  # values, pauli_sum, split, native
    assert pauli_expectation(_rotations(True), "xyz", backend=NumpyBackend()) == (
        ref_bind_expectation(_rotations(False)).values(["xyz"], RefNumpyBackend())[0])
    assert pauli_sum_expectation(_rotations(True), TERMS, backend=NumpyBackend()) == ref_total
    assert prog.values([], NumpyBackend()).shape == (0,)


def test_sliced_dispatch():
    """A structure over its ``target_size`` runs one slice-summed run per
    term (``sliced``), equal to the reference's batched numpy values."""
    paulis = [p for _, p in TERMS]
    want = ref_bind_expectation(_rotations(False, 4, 3)).values(
        [p + "z" for p in paulis], RefNumpyBackend())
    from tnc_tpu_torch.contractionpath.paths import Greedy, OptMethod

    network = _rotations(True, 4, 3).into_sandwich_template("pppp").network
    # a target just under the plan's peak: 4 slices (far under it, slicing
    # explodes)
    target = 0.5 * Greedy(OptMethod.GREEDY).find_path(network).size
    sliced = bind_expectation(_rotations(True, 4, 3), target_size=target)
    assert sliced.bound.sliced.slicing.num_slices == 4
    reset_dispatch()
    got = sliced.values([p + "z" for p in paulis], NumpyBackend())
    assert DISPATCH == {"sliced": 1}
    assert np.max(np.abs(got - want)) <= 1e-12


def test_plan_cache_and_default_backend(monkeypatch, tmp_path):
    import torch

    from tnc_tpu_torch.ops.backends import NumpyBackend
    from tnc_tpu_torch.serve import PlanCache

    cache = PlanCache(tmp_path)
    cold = bind_expectation(_rotations(True), plan_cache=cache)
    warm = bind_expectation(_rotations(True), plan_cache=cache)
    assert cache.stats()["counts"]["hit"] == 1
    assert warm.values(["zzz"], NumpyBackend()).tobytes() == \
        cold.values(["zzz"], NumpyBackend()).tobytes()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pauli_expectation(_rotations(True), "zzz")


@functools.lru_cache(maxsize=None)
def _reference_grad(terms, wrt, dtype):
    return ref_value_and_grad(_rotations(False), list(terms), wrt=wrt and list(wrt), dtype=dtype)


@pytest.mark.parametrize("dtype", ["complex128", "complex64"])
@pytest.mark.parametrize("wrt", [None, (3, 4, 12)], ids=["default", "slots"])
def test_value_and_grad_matches_reference(wrt, dtype):
    val, vals, grads = pauli_expectation_value_and_grad(
        _rotations(True), TERMS, wrt=wrt and list(wrt), dtype=dtype, device="cpu")
    want, want_vals, want_grads = _reference_grad(tuple(TERMS), wrt, dtype)
    tol = 1e-10 if dtype == "complex128" else REL
    assert isinstance(val, float)
    assert abs(val - want) <= tol * max(1.0, abs(want))
    assert vals.dtype == want_vals.dtype and np.max(np.abs(vals - want_vals)) <= tol
    assert len(grads) == len(want_grads)
    scale = max(float(np.max(np.abs(g))) for g in want_grads)
    for got, ref in zip(grads, want_grads):
        assert got.shape == ref.shape and got.dtype == ref.dtype
        assert float(np.max(np.abs(got - ref))) <= tol * scale


def test_theta_chain_rule_both_layers():
    """df/dθ composes the ket-layer AND adjoint-layer cotangents (the
    reference's ``test_queries.py`` case), in complex128 against the
    reference's cotangents and a central difference of the dense
    oracle."""
    theta = 0.7
    terms = [(1.0, "zi"), (0.5, "xx")]

    def mk(t=theta, port=True):
        c = (Circuit if port else RefCircuit)()
        data = TensorData if port else RefTensorData
        reg = c.allocate_register(2)
        c.append_gate(data.gate("rx", (t,)), [reg.qubit(0)])
        c.append_gate(data.gate("cx"), [reg.qubit(0), reg.qubit(1)])
        return c

    # sandwich flat leaves: [ket, ket, rx, cx, adj-ket, adj-ket, adj-rx,
    # adj-cx, obs, obs] → rx is slot 2, its mirror slot 6
    _val, _vals, (g_ket, g_adj) = pauli_expectation_value_and_grad(
        mk(), terms, wrt=[2, 6], dtype="complex128", device="cpu")
    _r, _rv, (r_ket, r_adj) = ref_value_and_grad(mk(port=False), terms, wrt=[2, 6],
                                                 dtype="complex128")
    assert np.max(np.abs(g_ket - r_ket)) <= 1e-10 and np.max(np.abs(g_adj - r_adj)) <= 1e-10
    s, c_ = math.sin(theta / 2) / 2, math.cos(theta / 2) / 2
    dG = np.array([[-s, -1j * c_], [-1j * c_, -s]])
    # the adjoint leaf stores G† (conj-transpose for a 1-qubit gate)
    dfdth = float(np.sum(g_ket * dG).real + np.sum(g_adj * np.conj(dG).T).real)

    def f(t):
        state = port_sv.statevector(mk(t))
        return sum(coeff * port_sv.pauli_expectation(state, p).real for coeff, p in terms)

    eps = 1e-5
    fd = (f(theta + eps) - f(theta - eps)) / (2 * eps)
    assert abs(dfdth - fd) < 1e-8


def test_batched_sum_grads_match_singletons():
    terms = [(1.0, "zzi"), (-0.5, "xix")]
    _v, _vals, grads_sum = pauli_expectation_value_and_grad(
        _rotations(True), terms, wrt=[3, 4], dtype="complex128", device="cpu")
    singles = [
        pauli_expectation_value_and_grad(_rotations(True), [(coeff, p)], wrt=[3, 4],
                                         dtype="complex128", device="cpu")[2]
        for coeff, p in terms
    ]
    for i in range(2):
        np.testing.assert_allclose(grads_sum[i], singles[0][i] + singles[1][i],
                                   rtol=0, atol=1e-12)


def test_observable_slots_not_differentiable():
    n_leaves = len(flat_leaf_tensors(_rotations(True).into_sandwich_template("ppp").network))
    obs_slot = [n_leaves - 1]
    assert _message(lambda: pauli_expectation_value_and_grad(
        _rotations(True), "zzz", wrt=obs_slot, device="cpu")) == _message(
        lambda: ref_value_and_grad(_rotations(False), "zzz", wrt=obs_slot))
