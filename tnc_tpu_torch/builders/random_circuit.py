"""Random circuit generation (the port's copy of
``tnc_tpu.builders.random_circuit``).

:func:`random_circuit` places ``rounds`` rounds of Bernoulli-placed
{sx, sy, sz} single-qubit gates and fsim(0.3, 0.2) two-qubit gates on a
connectivity graph, closed as an amplitude network.
:func:`brickwork_circuit` is the dense brickwork ansatz (H layer, then
random-angle Rz rotations and alternating CX bricks per round),
:func:`brickwork_from_angles` the same recipe from explicit angles — the
parameterised circuit a variational user differentiates — and
:func:`brickwork_sweep` several angle settings sharing a prefix.
:func:`random_circuit_with_observable` and
:func:`random_circuit_with_set_observable` build a ⟨O⟩ expectation-value
network directly: observables in the middle, each gate paired with its
adjoint on the mirror side, and gates outside every observable's light
cone skipped. All draw from the caller's ``np.random.Generator`` in
exactly the reference's order, so one seed gives identical gates in both
packages.
"""

from __future__ import annotations

import numpy as np

from tnc_tpu_torch.builders.circuit_builder import Circuit
from tnc_tpu_torch.builders.connectivity import Connectivity, ConnectivityLayout
from tnc_tpu_torch.builders.tensorgeneration import random_sparse_tensor_data_with_rng
from tnc_tpu_torch.tensornetwork.tensor import CompositeTensor, LeafTensor
from tnc_tpu_torch.tensornetwork.tensordata import TensorData

_SINGLE_QUBIT_GATES = ("sx", "sy", "sz")
_OBSERVABLES = ("x", "y", "z")
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


def brickwork_sweep(
    qubits: int,
    depth: int,
    prefix_depth: int,
    settings: int,
    rng: np.random.Generator,
) -> list[Circuit]:
    """``settings`` brickwork angle settings of one ansatz sharing the
    first ``prefix_depth`` rounds' angles — the parameter-sweep serving
    workload: every circuit's contraction tree contains the same-valued
    prefix subtrees, so a cross-request
    :class:`~tnc_tpu_torch.serve.reuse.IntermediateStore` contracts them
    once store-wide. Deterministic in ``rng``.

    >>> sweep = brickwork_sweep(4, 3, 2, 2, np.random.default_rng(0))
    >>> len(sweep), len(sweep[0].tensor_network.tensors)
    (2, 25)
    """
    prefix_depth = max(0, min(int(prefix_depth), int(depth)))
    prefix = [
        [float(rng.uniform(0, 3)) for _ in range(qubits)]
        for _ in range(prefix_depth)
    ]
    out = []
    for _ in range(max(int(settings), 1)):
        suffix = [
            [float(rng.uniform(0, 3)) for _ in range(qubits)]
            for _ in range(depth - prefix_depth)
        ]
        out.append(brickwork_from_angles(qubits, prefix + suffix))
    return out


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


def random_circuit_with_observable(
    qubits: int,
    rounds: int,
    single_qubit_probability: float,
    two_qubit_probability: float,
    observable_probability: float,
    rng: np.random.Generator,
    connectivity: ConnectivityLayout,
) -> CompositeTensor:
    """Random ⟨O⟩ network with Bernoulli-placed observables."""
    observable_locations = [
        i for i in range(qubits) if rng.random() < observable_probability
    ]
    return random_circuit_with_set_observable(
        qubits,
        rounds,
        single_qubit_probability,
        two_qubit_probability,
        observable_locations,
        rng,
        connectivity,
    )


def random_circuit_with_set_observable(
    qubits: int,
    rounds: int,
    single_qubit_probability: float,
    two_qubit_probability: float,
    observable_location: list[int],
    rng: np.random.Generator,
    connectivity: ConnectivityLayout,
) -> CompositeTensor:
    """Random ⟨O⟩ network with observables on the given qubits.

    Gate placement walks *outward* from the observable layer: a qubit whose
    forward and backward edges coincide (no observable in its causal cone
    yet) contributes nothing, so gates there are skipped (the light-cone
    skip).

    Each qubit's ``open_edges[i] = (left, right)`` tracks the next open leg
    on the circuit side (left) and the adjoint-mirror side (right).
    """
    tn = CompositeTensor()
    observable_set = set(observable_location)

    open_edges: dict[int, tuple[int, int]] = {}
    next_edge = 0

    # Observable layer in the middle.
    for i in range(qubits):
        if i in observable_set:
            open_edges[i] = (next_edge, next_edge + 1)
            name = _OBSERVABLES[int(rng.integers(0, 3))]
            obs = LeafTensor.from_const([next_edge, next_edge + 1], 2)
            obs.data = TensorData.gate(name)
            tn.push_tensor(obs)
            next_edge += 2
        else:
            open_edges[i] = (0, 0)  # sentinel: not yet in any causal cone

    connectivity_pairs = _filtered_connectivity(connectivity, qubits)

    for _ in range(1, rounds):
        # Two-qubit gates (and their mirror adjoints), only where they can
        # affect an observable.
        for i, j in connectivity_pairs:
            if rng.random() >= two_qubit_probability:
                continue
            i_open = open_edges[i][0] != open_edges[i][1]
            j_open = open_edges[j][0] != open_edges[j][1]
            if not (i_open or j_open):
                continue
            if i_open:
                left_i, right_i = open_edges[i]
            else:
                left_i = right_i = next_edge
                next_edge += 1
            if j_open:
                left_j, right_j = open_edges[j]
            else:
                left_j = right_j = next_edge
                next_edge += 1

            left = LeafTensor.from_const(
                [next_edge, next_edge + 1, left_i, left_j], 2
            )
            left.data = TensorData.gate("fsim", _FSIM_ANGLES)
            tn.push_tensor(left)

            right = LeafTensor.from_const(
                [right_i, right_j, next_edge + 2, next_edge + 3], 2
            )
            right.data = TensorData.gate("fsim", _FSIM_ANGLES, adjoint=True)
            tn.push_tensor(right)

            open_edges[i] = (next_edge, next_edge + 2)
            open_edges[j] = (next_edge + 1, next_edge + 3)
            next_edge += 4

        # Single-qubit gates + mirrored adjoints.
        for i in range(qubits):
            left_index, right_index = open_edges[i]
            if rng.random() < single_qubit_probability and left_index != right_index:
                name = _SINGLE_QUBIT_GATES[int(rng.integers(0, 3))]

                left = LeafTensor.from_const([next_edge, left_index], 2)
                left.data = TensorData.gate(name)
                tn.push_tensor(left)

                right = LeafTensor.from_const([right_index, next_edge + 1], 2)
                right.data = TensorData.gate(name, adjoint=True)
                tn.push_tensor(right)

                open_edges[i] = (next_edge, next_edge + 1)
                next_edge += 2

    # Random initial states, shared by circuit and mirror sides.
    for i in range(qubits):
        left_index, right_index = open_edges[i]
        if left_index != right_index:
            state = random_sparse_tensor_data_with_rng([2], 1.0, rng)

            left_state = LeafTensor.from_const([left_index], 2)
            left_state.data = state
            tn.push_tensor(left_state)

            right_state = LeafTensor.from_const([right_index], 2)
            right_state.data = TensorData.matrix(
                np.conj(state.into_data())
            )
            tn.push_tensor(right_state)

    return tn
