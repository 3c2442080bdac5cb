"""The port's gradients (``tnc_tpu_torch.ops.autodiff`` and
``tensornetwork.sweep.amplitude_sweep_value_and_grad``) against the JAX
package's on the CPU.

- ``contraction_value_and_grad`` and ``sliced_contraction_value_and_grad``
  on three networks — the Rx expectation network of the reference's own
  tests, a 6-qubit ``random_circuit`` amplitude and a ``peps(2, 3, 2, 2,
  1)`` norm — each side with its own builders, path and slicing from the
  same seeds: values and cotangents to 1e-10·max|g| in complex128 and
  1e-5·max|g| in complex64; sliced equal to unsliced to 1e-10 in
  complex128.
- The convention: the port returns ``conj`` of PyTorch's ``.grad``, which
  is JAX's cotangent.
- ``amplitude_sweep_value_and_grad`` against the reference on the same
  circuit and bitstrings (default and a caller's ``scalar_fn``).
- Errors: ``_validate_wrt`` and the bra-slot rejection carry the
  reference's messages; with no device every entry point takes CUDA and
  raises without it.
"""

import doctest
import functools

import numpy as np
import pytest
import torch

import tnc_tpu.ops.autodiff as ref_autodiff
import tnc_tpu_torch.ops.autodiff as port_autodiff
from tnc_tpu.builders.circuit_builder import Circuit as RefCircuit
from tnc_tpu.builders.connectivity import ConnectivityLayout as RefLayout
from tnc_tpu.builders.peps import peps as ref_peps
from tnc_tpu.builders.random_circuit import random_open_circuit as ref_random_open
from tnc_tpu.contractionpath.paths import Greedy as RefGreedy
from tnc_tpu.contractionpath.paths import OptMethod as RefOptMethod
from tnc_tpu.contractionpath.slicing import find_slicing as ref_find_slicing
from tnc_tpu.tensornetwork.approximate import attach_random_data as ref_attach
from tnc_tpu.tensornetwork.sweep import (
    amplitude_sweep_value_and_grad as ref_sweep_grad,
)
from tnc_tpu.tensornetwork.tensordata import TensorData as RefTensorData
from tnc_tpu_torch.builders.circuit_builder import Circuit
from tnc_tpu_torch.builders.connectivity import ConnectivityLayout
from tnc_tpu_torch.builders.peps import peps
from tnc_tpu_torch.builders.random_circuit import random_open_circuit
from tnc_tpu_torch.contractionpath.paths import Greedy, OptMethod
from tnc_tpu_torch.contractionpath.slicing import find_slicing
from tnc_tpu_torch.ops.autodiff import (
    contraction_value_and_grad,
    sliced_contraction_value_and_grad,
)
from tnc_tpu_torch.ops.program import flat_leaf_tensors
from tnc_tpu_torch.tensornetwork.approximate import attach_random_data
from tnc_tpu_torch.tensornetwork.sweep import amplitude_sweep_value_and_grad
from tnc_tpu_torch.tensornetwork.tensordata import TensorData

CASES = ("rx", "random6", "peps23")
# slicing target as a share of the path's peak: 4, 16 and 4 slices (a
# quarter of the peak would give random6 524288)
TARGET = {"rx": 0.75, "random6": 0.75, "peps23": 0.5}
TOL = {"complex128": 1e-10, "complex64": 1e-5}


def _rx(port: bool):
    c = (Circuit if port else RefCircuit)()
    reg = c.allocate_register(2)
    data = TensorData if port else RefTensorData
    c.append_gate(data.gate("rx", (0.7,)), [reg.qubit(0)])
    c.append_gate(data.gate("cx"), [reg.qubit(0), reg.qubit(1)])
    c.append_gate(data.gate("ry", (0.4,)), [reg.qubit(1)])
    return c.into_expectation_value_network("zx")


def _random6(port: bool):
    build = random_open_circuit if port else ref_random_open
    layout = (ConnectivityLayout if port else RefLayout).LINE
    circuit = build(6, 5, 0.5, 0.5, np.random.default_rng(5), layout)
    return circuit.into_amplitude_network("010110")[0]


def _peps23(port: bool):
    tn = (peps if port else ref_peps)(2, 3, 2, 2, 1)
    return (attach_random_data if port else ref_attach)(tn, np.random.default_rng(3))


@functools.lru_cache(maxsize=None)
def _network(case: str, port: bool, sliced: bool):
    """``(tn, path, slicing)`` built on one side with its own builders,
    ``Greedy`` and ``find_slicing`` (to ``TARGET`` of the path's peak)."""
    tn = {"rx": _rx, "random6": _random6, "peps23": _peps23}[case](port)
    greedy, opt, find = ((Greedy, OptMethod, find_slicing) if port
                         else (RefGreedy, RefOptMethod, ref_find_slicing))
    result = greedy(opt.GREEDY).find_path(tn)
    path = result.replace_path()
    slicing = find(tn.tensors, path.toplevel, result.size * TARGET[case]) if sliced else None
    return tn, path, slicing


def _run(case, port, sliced, dtype, **kw):
    tn, path, slicing = _network(case, port, sliced)
    if port:
        kw["device"] = "cpu"
        fn_plain, fn_sliced = contraction_value_and_grad, sliced_contraction_value_and_grad
    else:
        fn_plain = ref_autodiff.contraction_value_and_grad
        fn_sliced = ref_autodiff.sliced_contraction_value_and_grad
    if sliced:
        return fn_sliced(tn, path, slicing, dtype=dtype, **kw)
    return fn_plain(tn, path, dtype=dtype, **kw)


@functools.lru_cache(maxsize=None)
def _reference(case, sliced, dtype):
    return _run(case, False, sliced, dtype)


def test_doctests():
    assert doctest.testmod(port_autodiff).failed == 0


@pytest.mark.parametrize("sliced", [False, True], ids=["unsliced", "sliced"])
@pytest.mark.parametrize("dtype", ["complex128", "complex64"])
@pytest.mark.parametrize("case", CASES)
def test_value_and_grad_match_reference(case, dtype, sliced):
    if sliced:
        port_sl, ref_sl = _network(case, True, True)[2], _network(case, False, True)[2]
        assert port_sl.legs == ref_sl.legs and port_sl.num_slices > 1
    value, grads = _run(case, True, sliced, dtype)
    want_value, want_grads = _reference(case, sliced, dtype)
    n_leaves = len(flat_leaf_tensors(_network(case, True, sliced)[0]))
    assert len(grads) == len(want_grads) == n_leaves
    assert value.shape == want_value.shape
    assert value.dtype == want_value.dtype == np.dtype(dtype)
    scale = max(float(np.max(np.abs(g))) for g in want_grads)
    assert scale > 0.0
    tol = TOL[dtype]
    assert abs(complex(value.reshape(-1)[0]) - complex(want_value.reshape(-1)[0])) <= tol * max(
        1.0, abs(complex(want_value.reshape(-1)[0])))
    for got, want in zip(grads, want_grads):
        assert got.shape == want.shape and got.dtype == want.dtype
        assert float(np.max(np.abs(got - want))) <= tol * scale


@pytest.mark.parametrize("case", CASES)
def test_sliced_equals_unsliced(case):
    value, grads = _run(case, True, False, "complex128")
    value_s, grads_s = _run(case, True, True, "complex128")
    assert np.max(np.abs(value_s - value)) <= 1e-10
    for gs, g in zip(grads_s, grads):
        assert float(np.max(np.abs(gs - g))) <= 1e-10


def test_cotangent_is_conj_of_torch_grad_and_equals_jax():
    """``f = Re(Σ z·w) + Σ|z|²``: JAX's cotangent is ``w + 2·conj(z)``
    (``df = Re(Σ g·dz)``), PyTorch's ``.grad`` its conjugate; the port's
    cotangent helper turns the latter into the former, and a contraction
    gradient meets ``df = Re(Σ g·dT)`` exactly on a leaf it is linear in."""
    import jax
    import jax.numpy as jnp

    z = np.array([1.0 + 2.0j, -0.5 + 1.5j])
    w = np.array([0.3 - 0.7j, 4.0 - 0.0j])

    def f_jax(x):
        return jnp.real(jnp.sum(x * w)) + jnp.sum(jnp.abs(x) ** 2)

    want = np.asarray(jax.grad(f_jax)(jnp.asarray(z)))
    zt = torch.tensor(z, requires_grad=True)
    f = torch.real(torch.sum(zt * torch.tensor(w))) + torch.sum(zt.abs() ** 2)
    f.backward()
    torch_grad = zt.grad.numpy()
    assert np.allclose(torch_grad, np.conj(want), rtol=0, atol=1e-12)
    assert not np.allclose(torch_grad, want)
    (ours,) = port_autodiff.cotangents([zt.grad])
    assert np.allclose(ours, want, rtol=0, atol=1e-12)

    # on a contraction: the real part of an amplitude is linear in each
    # leaf, so f(T + dT) - f(T) = Re(Σ g·dT) exactly
    tn, path, _ = _network("random6", True, False)
    slot = 7
    value, (g,) = contraction_value_and_grad(tn, path, wrt=[slot], dtype="complex128",
                                             device="cpu")
    rng = np.random.default_rng(0)
    d = rng.standard_normal(g.shape) + 1j * rng.standard_normal(g.shape)
    leaves = flat_leaf_tensors(tn)
    old = leaves[slot].data
    try:
        leaves[slot].data = TensorData.matrix(old.into_data() + d)
        moved, _ = contraction_value_and_grad(tn, path, wrt=[slot], dtype="complex128",
                                              device="cpu")
    finally:
        leaves[slot].data = old
    df = complex(moved.reshape(-1)[0]).real - complex(value.reshape(-1)[0]).real
    assert abs(df - float(np.sum(g * d).real)) <= 1e-12


def _sweep_case(port: bool):
    build = random_open_circuit if port else ref_random_open
    layout = (ConnectivityLayout if port else RefLayout).LINE
    return build(6, 5, 0.5, 0.5, np.random.default_rng(11), layout)


SWEEP_BITS = ["000000", "101101", "111000", "010011"]


@pytest.mark.parametrize("scalar", ["default", "real_sum"])
@pytest.mark.parametrize("dtype", ["complex128", "complex64"])
def test_sweep_value_and_grad_matches_reference(dtype, scalar):
    port_fn = ref_fn = None
    if scalar == "real_sum":
        import jax.numpy as jnp

        def port_fn(amps):
            return torch.sum(amps.real * torch.arange(1, amps.shape[0] + 1))

        def ref_fn(amps):
            return jnp.sum(jnp.real(amps) * jnp.arange(1, amps.shape[0] + 1))

    amps, grads = amplitude_sweep_value_and_grad(
        _sweep_case(True), SWEEP_BITS, scalar_fn=port_fn, dtype=dtype, device="cpu")
    want_amps, want_grads = ref_sweep_grad(_sweep_case(False), SWEEP_BITS,
                                           scalar_fn=ref_fn, dtype=dtype)
    tol = TOL[dtype]
    assert amps.shape == want_amps.shape == (len(SWEEP_BITS),)
    assert float(np.max(np.abs(amps - want_amps))) <= tol * float(np.max(np.abs(want_amps)))
    assert len(grads) == len(want_grads)
    scale = max(float(np.max(np.abs(g))) for g in want_grads)
    for got, want in zip(grads, want_grads):
        assert got.shape == want.shape
        assert float(np.max(np.abs(got - want))) <= tol * scale


def _message(fn) -> str:
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


@pytest.mark.parametrize("wrt", [[0, 0], [99], [-1]], ids=["duplicate", "high", "negative"])
def test_validate_wrt_messages(wrt):
    assert _message(lambda: port_autodiff._validate_wrt(wrt, 5)) == _message(
        lambda: ref_autodiff._validate_wrt(wrt, 5))
    tn, path, _ = _network("rx", True, False)
    ref_tn, ref_path, _ = _network("rx", False, False)
    assert _message(lambda: contraction_value_and_grad(tn, path, wrt=wrt, device="cpu")) == (
        _message(lambda: ref_autodiff.contraction_value_and_grad(ref_tn, ref_path, wrt=wrt)))


def test_sweep_rejects_bra_slots_and_empty_input():
    n_slots = len(flat_leaf_tensors(_sweep_case(True).into_amplitude_network(SWEEP_BITS[0])[0]))
    bra = [n_slots - 1]
    assert _message(lambda: amplitude_sweep_value_and_grad(
        _sweep_case(True), SWEEP_BITS, wrt=bra, device="cpu")) == _message(
        lambda: ref_sweep_grad(_sweep_case(False), SWEEP_BITS, wrt=bra))
    assert _message(lambda: amplitude_sweep_value_and_grad(_sweep_case(True), [],
                                                           device="cpu")) == _message(
        lambda: ref_sweep_grad(_sweep_case(False), []))


@pytest.mark.parametrize("entry", ["plain", "sliced", "sweep", "expectation"])
def test_entry_points_take_cuda_by_default(entry, monkeypatch):
    """With no ``device`` the gradients run on the card: without CUDA they
    raise instead of running on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tn, path, slicing = _network("random6", True, True)
    if entry == "plain":
        call = functools.partial(contraction_value_and_grad, tn, path)
    elif entry == "sliced":
        call = functools.partial(sliced_contraction_value_and_grad, tn, path, slicing)
    elif entry == "sweep":
        call = functools.partial(amplitude_sweep_value_and_grad, _sweep_case(True), SWEEP_BITS)
    else:
        from tnc_tpu_torch.queries.expectation import pauli_expectation_value_and_grad

        call = functools.partial(pauli_expectation_value_and_grad, _sweep_case(True), "z" * 6)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()
