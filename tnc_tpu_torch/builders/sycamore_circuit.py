"""Sycamore-style random circuit generation (the port's copy of
``tnc_tpu.builders.sycamore_circuit``).

Mirror of ``tnc/src/builders/sycamore_circuit.rs:23-74`` (circuit scheme
from arXiv:1910.11333): ``depth`` rounds, each a layer of random
single-qubit gates from {sx, sy, sz} followed by a layer of
fsim(pi/2, pi/6) two-qubit gates on the round's activation pattern, cycling
[a, b, c, d, c, d, a, b]; a final single-qubit layer closes the circuit.
Pattern qubit labels are 1-based; pairs outside the qubit count are
skipped, as in the reference.
"""

from __future__ import annotations

import math
from itertools import cycle

import numpy as np

from tnc_tpu_torch.builders.circuit_builder import Circuit
from tnc_tpu_torch.builders.connectivity import (
    sycamore_a,
    sycamore_b,
    sycamore_c,
    sycamore_d,
)
from tnc_tpu_torch.tensornetwork.tensordata import TensorData

_SINGLE_QUBIT_GATES = ("sx", "sy", "sz")


def sycamore_circuit(
    qubits: int, depth: int, rng: np.random.Generator | None = None
) -> Circuit:
    """Build a Sycamore-scheme circuit on ``qubits`` qubits with ``depth``
    rounds. ``qubits`` is capped at 53 (the original device size).

    >>> import numpy as np
    >>> tn, _ = sycamore_circuit(12, 4, np.random.default_rng(1)
    ...     ).into_amplitude_network("0" * 12)
    >>> len(tn.tensors) > 12 and tn.external_tensor().legs == []
    True
    >>> sycamore_circuit(54, 1)
    Traceback (most recent call last):
        ...
    ValueError: Only circuits up to the original 53-qubit Sycamore device are supported
    """
    if qubits > 53:
        raise ValueError(
            "Only circuits up to the original 53-qubit Sycamore device are supported"
        )
    if rng is None:
        rng = np.random.default_rng()

    rounds = cycle(
        [
            sycamore_a, sycamore_b, sycamore_c, sycamore_d,
            sycamore_c, sycamore_d, sycamore_a, sycamore_b,
        ]
    )
    two_qubit_gate = TensorData.gate("fsim", (math.pi / 2.0, math.pi / 6.0))

    circuit = Circuit()
    qreg = circuit.allocate_register(qubits)

    for round_idx in range(depth + 1):
        for i in range(qubits):
            name = _SINGLE_QUBIT_GATES[int(rng.integers(0, 3))]
            circuit.append_gate(TensorData.gate(name), [qreg.qubit(i)])
        if round_idx < depth:
            layer = next(rounds)()
            for i, j in layer:
                if i > qubits or j > qubits:
                    continue
                circuit.append_gate(
                    two_qubit_gate, [qreg.qubit(i - 1), qreg.qubit(j - 1)]
                )
    return circuit
