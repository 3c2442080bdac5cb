"""The slice as a whole on the CPU: the port's ``contract_tensor_network``
with ``TorchBackend(device="cpu", split_complex=True)`` against the
reference's ``JaxBackend(split_complex=True)`` (Pallas in interpret mode)
under every forcing mode, and against the complex128 numpy oracles.

Tolerances: against the float32 JAX run, 1e-4·max|ref| (two float32
executions of the same plan, summed in different orders); against the
complex128 oracle, BASELINE's amplitude parity of 1e-5 absolute.
"""

import importlib

import numpy as np
import pytest
import torch

import tnc_tpu.builders.circuit_builder as ref_cb
import tnc_tpu.tensornetwork.tensordata as ref_td
from tnc_tpu.builders.connectivity import ConnectivityLayout as RefLayout
from tnc_tpu.contractionpath.paths import Greedy as RefGreedy
from tnc_tpu.contractionpath.paths import OptMethod as RefOptMethod
from tnc_tpu.ops.backends import JaxBackend
from tnc_tpu.ops.backends import NumpyBackend as RefNumpyBackend
from tnc_tpu.tensornetwork.contraction import contract_tensor_network as ref_contract
from tnc_tpu_torch.builders.circuit_builder import Circuit
from tnc_tpu_torch.builders.connectivity import ConnectivityLayout
from tnc_tpu_torch.builders.random_circuit import random_circuit
from tnc_tpu_torch.contractionpath.paths import Greedy, OptMethod
from tnc_tpu_torch.ops import backends as port_backends
from tnc_tpu_torch.ops.backends import NumpyBackend, TorchBackend, get_backend
from tnc_tpu_torch.ops.cuda_complex import LAUNCHES, reset_launches
from tnc_tpu_torch.ops.split_complex import FUSED_ROUTED, reset_routed
from tnc_tpu_torch.tensornetwork.contraction import contract_tensor_network
from tnc_tpu_torch.tensornetwork.tensordata import TensorData

ref_rc = importlib.import_module("tnc_tpu.builders.random_circuit")

MODES = ["auto", "chain", "fused", "naive", "gauss"]


def _random_pair(qubits=10, seed=42):
    port = random_circuit(qubits, 12, 0.4, 0.4, np.random.default_rng(seed),
                          ConnectivityLayout.SYCAMORE, bitstring="*" * qubits)
    ref = ref_rc.random_circuit(qubits, 12, 0.4, 0.4, np.random.default_rng(seed),
                                RefLayout.SYCAMORE, bitstring="*" * qubits)
    return port, ref


def _ghz_pair(qubits=6):
    def build(cb, td):
        c = cb.Circuit()
        reg = c.allocate_register(qubits)
        c.append_gate(td.TensorData.gate("h"), [reg.qubit(0)])
        for i in range(qubits - 1):
            c.append_gate(td.TensorData.gate("cx"), [reg.qubit(i), reg.qubit(i + 1)])
        return c.into_statevector_network()[0]

    import tnc_tpu_torch.builders.circuit_builder as port_cb
    import tnc_tpu_torch.tensornetwork.tensordata as port_td

    return build(port_cb, port_td), build(ref_cb, ref_td)


NETWORKS = {"random10": _random_pair, "ghz6": _ghz_pair}


def _contract_both(name, backend, ref_backend):
    port_tn, ref_tn = NETWORKS[name]()
    port_path = Greedy(OptMethod.GREEDY).find_path(port_tn).replace_path()
    ref_path = RefGreedy(RefOptMethod.GREEDY).find_path(ref_tn).replace_path()
    assert port_path.toplevel == ref_path.toplevel
    got = contract_tensor_network(port_tn, port_path, backend)
    want = ref_contract(ref_tn, ref_path, ref_backend)
    assert got.legs == want.legs and got.bond_dims == want.bond_dims
    return np.asarray(got.data.into_data()), np.asarray(want.data.into_data())


@pytest.mark.parametrize("name", sorted(NETWORKS))
@pytest.mark.parametrize("mode", MODES)
def test_split_torch_matches_split_jax(name, mode, monkeypatch):
    monkeypatch.setenv("TNC_TPU_COMPLEX_MULT", mode)
    got, want = _contract_both(
        name,
        TorchBackend(device="cpu", split_complex=True),
        JaxBackend(dtype="complex64", split_complex=True, precision="float32"),
    )
    scale = float(np.max(np.abs(want)))
    assert float(np.max(np.abs(got - want))) <= 1e-4 * scale


@pytest.mark.parametrize("name", sorted(NETWORKS))
@pytest.mark.parametrize(
    "backend",
    [
        dict(split_complex=True),
        dict(split_complex=False),
        dict(split_complex=True, dtype="complex128"),
    ],
    ids=["split64", "native64", "split128"],
)
def test_torch_matches_complex128_oracle(name, backend):
    got, want = _contract_both(name, TorchBackend(device="cpu", **backend),
                               RefNumpyBackend())
    assert float(np.max(np.abs(got - want))) <= 1e-5
    _, port_oracle = _contract_both(name, NumpyBackend(), RefNumpyBackend())
    assert np.array_equal(port_oracle, want)


def test_complex128_split_is_exact_to_float64():
    got, want = _contract_both(
        "random10", TorchBackend(device="cpu", split_complex=True, dtype="complex128"),
        RefNumpyBackend(),
    )
    assert float(np.max(np.abs(got - want))) <= 1e-12


def test_statevector_is_normalized_and_counters_stay_on_host():
    """No kernel launches on the CPU; the forced ``fused`` rung counts
    every step it routes to the naive dots."""
    reset_launches()
    reset_routed()
    got, _ = _contract_both("random10", TorchBackend(device="cpu"), RefNumpyBackend())
    assert abs(float(np.vdot(got, got).real) - 1.0) <= 1e-5
    assert LAUNCHES == {"fused_chain": 0, "fused_complex_dot": 0, "fused_transpose_dot": 0}


def test_fused_rung_counts_routed_steps(monkeypatch):
    monkeypatch.setenv("TNC_TPU_COMPLEX_MULT", "fused")
    reset_routed()
    port_tn, _ = _random_pair()
    path = Greedy(OptMethod.GREEDY).find_path(port_tn).replace_path()
    contract_tensor_network(port_tn, path, TorchBackend(device="cpu", split_complex=True))
    # every step of a 10-qubit program is under the flop floor or not
    # contract-first: all of them are routed, and counted by reason
    assert sum(FUSED_ROUTED.values()) == len(path.toplevel)
    assert set(FUSED_ROUTED) <= {"layout", "flop_floor"}


def test_ghz_amplitude():
    c = Circuit()
    reg = c.allocate_register(3)
    c.append_gate(TensorData.gate("h"), [reg.qubit(0)])
    for i in range(2):
        c.append_gate(TensorData.gate("cx"), [reg.qubit(i), reg.qubit(i + 1)])
    tn, _ = c.into_amplitude_network("111")
    path = Greedy(OptMethod.GREEDY).find_path(tn).replace_path()
    out = contract_tensor_network(tn, path, TorchBackend(device="cpu", split_complex=True))
    assert abs(complex(out.data.into_data()) - 1 / np.sqrt(2)) < 1e-6


def test_default_device_raises_without_cuda(monkeypatch):
    """``TorchBackend()`` means the GPU: without CUDA it raises instead of
    running on the CPU, and so do the ``torch`` backend name, the default
    backend and ``contract_tensor_network`` called without a backend."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(port_backends, "_BACKENDS", {})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchBackend()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_backend("torch")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_backend(None)
    tn, _ = _random_pair(6, 1)
    path = Greedy(OptMethod.GREEDY).find_path(tn).replace_path()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        contract_tensor_network(tn, path)


def test_backend_options_and_resolution():
    cpu = TorchBackend(device="cpu")
    assert cpu.split_complex is False
    assert get_backend(cpu) is cpu
    assert isinstance(get_backend("numpy"), NumpyBackend)
    with pytest.raises(ValueError, match="Unknown backend"):
        get_backend("jax")
    with pytest.raises(ValueError, match="precision"):
        TorchBackend(device="cpu", precision="tf32")
    with pytest.raises(ValueError, match="dtype"):
        TorchBackend(device="cpu", dtype="float32")


def test_bind_resident_reuses_inputs():
    port_tn, _ = _random_pair(8, 1)
    from tnc_tpu_torch.ops.program import build_program, flat_leaf_tensors

    path = Greedy(OptMethod.GREEDY).find_path(port_tn).replace_path()
    program = build_program(port_tn, path)
    arrays = [l.data.into_data() for l in flat_leaf_tensors(port_tn)]
    backend = TorchBackend(device="cpu", split_complex=True)
    run = backend.bind_resident(program, arrays)
    first, second = run(), run()
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])
    want = NumpyBackend().execute(program, arrays).reshape(-1)
    got = torch.complex(*first).numpy().reshape(-1)
    assert float(np.max(np.abs(got - want))) <= 1e-5
