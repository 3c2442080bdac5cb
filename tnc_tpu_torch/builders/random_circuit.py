"""Random circuit generation (the port's copy of
``tnc_tpu.builders.random_circuit``, trimmed to :func:`random_circuit`
and the brickwork recipe).

:func:`random_circuit` places ``rounds`` rounds of Bernoulli-placed
{sx, sy, sz} single-qubit gates and fsim(0.3, 0.2) two-qubit gates on a
connectivity graph, closed as an amplitude network.
:func:`brickwork_circuit` is the dense brickwork ansatz (H layer, then
random-angle Rz rotations and alternating CX bricks per round), and
:func:`brickwork_from_angles` the same recipe from explicit angles — the
parameterised circuit a variational user differentiates. Both draw from
the caller's ``np.random.Generator`` in exactly the reference's order, so
one seed gives identical gates in both packages.
"""

from __future__ import annotations

import numpy as np

from tnc_tpu_torch.builders.circuit_builder import Circuit
from tnc_tpu_torch.builders.connectivity import Connectivity, ConnectivityLayout
from tnc_tpu_torch.tensornetwork.tensor import CompositeTensor
from tnc_tpu_torch.tensornetwork.tensordata import TensorData

_SINGLE_QUBIT_GATES = ("sx", "sy", "sz")
_FSIM_ANGLES = (0.3, 0.2)


def _filtered_connectivity(
    layout: ConnectivityLayout, qubits: int
) -> list[tuple[int, int]]:
    graph = Connectivity.new(layout, qubits)
    return [(u, v) for (u, v) in graph.connectivity if u < qubits and v < qubits]


def random_open_circuit(
    qubits: int,
    rounds: int,
    single_qubit_probability: float,
    two_qubit_probability: float,
    rng: np.random.Generator,
    connectivity: ConnectivityLayout,
) -> Circuit:
    """The unfinalized random circuit (gates only, no bras) — feed it to
    either finalizer."""
    connectivity_pairs = _filtered_connectivity(connectivity, qubits)

    circuit = Circuit()
    qr = circuit.allocate_register(qubits)

    for _ in range(1, rounds):
        for i in range(qubits):
            if rng.random() < single_qubit_probability:
                name = _SINGLE_QUBIT_GATES[int(rng.integers(0, 3))]
                circuit.append_gate(TensorData.gate(name), [qr.qubit(i)])
        for i, j in connectivity_pairs:
            if rng.random() < two_qubit_probability:
                circuit.append_gate(
                    TensorData.gate("fsim", _FSIM_ANGLES), [qr.qubit(i), qr.qubit(j)]
                )
    return circuit


def brickwork_circuit(
    qubits: int, depth: int, rng: np.random.Generator
) -> Circuit:
    """Dense brickwork circuit (H layer, then per-round random-angle Rz
    rotations + alternating CX bricks), unfinalized. Deterministic in
    ``rng``: same generator state → identical structure AND gate values.

    >>> c = brickwork_circuit(4, 2, np.random.default_rng(0))
    >>> len(c.tensor_network.tensors)  # 4 kets, 4 h, 8 rz, 3 cx
    19
    """
    angles = [
        [float(rng.uniform(0, 3)) for _ in range(qubits)]
        for _ in range(depth)
    ]
    return brickwork_from_angles(qubits, angles)


def brickwork_from_angles(
    qubits: int, round_angles: list[list[float]]
) -> Circuit:
    """The brickwork recipe with explicit per-round Rz angles —
    :func:`brickwork_circuit`'s builder, exposed so a caller can set
    (or differentiate) the angles."""
    circuit = Circuit()
    qr = circuit.allocate_register(qubits)
    for q in range(qubits):
        circuit.append_gate(TensorData.gate("h"), [qr.qubit(q)])
    for d, angles in enumerate(round_angles):
        for q in range(qubits):
            circuit.append_gate(TensorData.gate("rz", (angles[q],)), [qr.qubit(q)])
        for q in range(d % 2, qubits - 1, 2):
            circuit.append_gate(TensorData.gate("cx"), [qr.qubit(q), qr.qubit(q + 1)])
    return circuit


def random_circuit(
    qubits: int,
    rounds: int,
    single_qubit_probability: float,
    two_qubit_probability: float,
    rng: np.random.Generator,
    connectivity: ConnectivityLayout,
    bitstring: str | None = None,
) -> CompositeTensor:
    """Random circuit closed as an amplitude network.

    ``bitstring`` defaults to |0…0⟩; pass ``"*" * qubits`` for an open
    statevector network.

    >>> import numpy as np
    >>> from tnc_tpu_torch.builders.connectivity import ConnectivityLayout
    >>> tn = random_circuit(6, 4, 0.5, 0.5, np.random.default_rng(0),
    ...                     ConnectivityLayout.LINE)
    >>> tn.external_tensor().legs          # amplitude: fully closed
    []
    >>> sv = random_circuit(6, 4, 0.5, 0.5, np.random.default_rng(0),
    ...                     ConnectivityLayout.LINE, bitstring="*" * 6)
    >>> len(sv.external_tensor().legs)     # statevector: 6 open legs
    6
    """
    circuit = random_open_circuit(
        qubits,
        rounds,
        single_qubit_probability,
        two_qubit_probability,
        rng,
        connectivity,
    )
    if bitstring is None:
        bitstring = "0" * qubits
    return circuit.into_amplitude_network(bitstring)[0]
