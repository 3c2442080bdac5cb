"""QAOA circuit generation (the port's copy of
``tnc_tpu.builders.qaoa_circuit``).

BASELINE config #4 is a 30-qubit QAOA Pauli-string expectation value.
This builder produces the standard QAOA ansatz for MaxCut on a given
coupling graph:

    |+…+>  then p rounds of  [ exp(-i γ Z_u Z_v) on every edge,
                               exp(-i β X_q) on every qubit ]

with ZZ interactions compiled to the cx–rz–cx pattern. It draws γ then
β per round from the caller's ``np.random.Generator``, as the reference
does, so one seed gives identical gates in both packages. The circuit
closes as a ⟨ψ|Z…Z|ψ⟩ expectation network via
``Circuit.into_expectation_value_network``.
"""

from __future__ import annotations

import numpy as np

from tnc_tpu_torch.builders.circuit_builder import Circuit
from tnc_tpu_torch.builders.connectivity import Connectivity, ConnectivityLayout
from tnc_tpu_torch.tensornetwork.tensordata import TensorData


def qaoa_circuit(
    qubits: int,
    rounds: int,
    rng: np.random.Generator,
    layout: ConnectivityLayout = ConnectivityLayout.LINE,
) -> Circuit:
    """QAOA MaxCut ansatz with ``rounds`` (γ, β) layers of random angles
    on the ``layout`` coupling graph (default: a line of ``qubits``).

    >>> c = qaoa_circuit(4, 2, np.random.default_rng(0))
    >>> tn = c.into_expectation_value_network()
    >>> tn.external_tensor().legs  # <psi|Z...Z|psi> closes every leg
    []
    """
    graph = Connectivity.new(layout, qubits)
    edges = [(u, v) for (u, v) in graph.connectivity if u < qubits and v < qubits]

    circuit = Circuit()
    reg = circuit.allocate_register(qubits)

    for q in range(qubits):
        circuit.append_gate(TensorData.gate("h"), [reg.qubit(q)])

    for _ in range(rounds):
        gamma = float(rng.uniform(0, 2 * np.pi))
        beta = float(rng.uniform(0, np.pi))
        for u, v in edges:
            # exp(-i gamma Z_u Z_v) = cx(u,v) rz(2*gamma, v) cx(u,v)
            circuit.append_gate(TensorData.gate("cx"), [reg.qubit(u), reg.qubit(v)])
            circuit.append_gate(TensorData.gate("rz", (2.0 * gamma,)), [reg.qubit(v)])
            circuit.append_gate(TensorData.gate("cx"), [reg.qubit(u), reg.qubit(v)])
        for q in range(qubits):
            circuit.append_gate(TensorData.gate("rx", (2.0 * beta,)), [reg.qubit(q)])
    return circuit
