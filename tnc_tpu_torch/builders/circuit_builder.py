"""Quantum-circuit → tensor-network builder (the port's copy of
``tnc_tpu.builders.circuit_builder``, trimmed to the amplitude and
statevector finalizers):

- ``allocate_register(n)`` pushes |0⟩ kets, one edge each.
- ``append_gate(data, qubits)`` creates a tensor whose legs are the *new*
  output edges first, then the old input edges (``edges = new ++ old``) —
  matching the gate storage layout ``(out…, in…)``.
- Two finalizers: ``into_amplitude_network(bitstring)`` (``0``/``1``/``*``
  wildcards → open legs) and ``into_statevector_network()`` (all
  wildcards).
- A :class:`Permutor` restores natural qubit order after contraction,
  since the contraction can emit the open legs in any order.
"""

from __future__ import annotations

from typing import Iterable, Iterator, Sequence

import numpy as np

from tnc_tpu_torch.tensornetwork.tensor import CompositeTensor, EdgeIndex, LeafTensor
from tnc_tpu_torch.tensornetwork.tensordata import TensorData


def normalize_bitstring(
    bitstring: str | Iterable, num_qubits: int | None = None
) -> str:
    """Canonicalize a bitstring spec to a ``str`` of ``0``/``1``/``*``.

    Accepts a plain string or an iterable of per-qubit states: the
    characters ``"0"``/``"1"``/``"*"``, the ints ``0``/``1``, or
    ``None`` (= open leg, like ``"*"``). Errors name the offending
    state *and its position*, so a 53-character Sycamore bitstring with
    one typo is debuggable.

    >>> normalize_bitstring([0, 1, None, "1"])
    '01*1'
    >>> normalize_bitstring("01x1")
    Traceback (most recent call last):
        ...
    ValueError: invalid bitstring character 'x' at position 2 (only '0', '1' and '*' are allowed)
    """
    chars: list[str] = []
    for pos, state in enumerate(bitstring):
        if isinstance(state, str) and state in ("0", "1", "*"):
            chars.append(state)
        elif state is None:
            chars.append("*")
        elif (
            isinstance(state, (int, np.integer))
            and not isinstance(state, bool)
            and state in (0, 1)
        ):
            chars.append(str(int(state)))
        else:
            what = (
                f"character {state!r}"
                if isinstance(state, str)
                else f"state {state!r}"
            )
            raise ValueError(
                f"invalid bitstring {what} at position {pos} "
                "(only '0', '1' and '*' are allowed)"
            )
    if num_qubits is not None and len(chars) != num_qubits:
        raise ValueError(
            f"bitstring length {len(chars)} != qubit count {num_qubits}"
        )
    return "".join(chars)


class Qubit:
    """A single qubit handle (global index into the circuit)."""

    __slots__ = ("index",)

    def __init__(self, index: int) -> None:
        self.index = index


class QuantumRegister:
    """An array of qubits (``circuit_builder.rs:21-67``)."""

    def __init__(self, base: int, size: int) -> None:
        self.base = base
        self.size = size

    def qubit(self, index: int) -> Qubit:
        if not 0 <= index < self.size:
            raise IndexError(f"qubit index {index} out of range for register of size {self.size}")
        return Qubit(self.base + index)

    def qubits(self) -> Iterator[Qubit]:
        return (Qubit(i) for i in range(self.base, self.base + self.size))

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, index: int) -> Qubit:
        return self.qubit(index)


class Permutor:
    """Transposes the final tensor to the target (natural) leg order
    (``circuit_builder.rs:77-122``).

    >>> from tnc_tpu_torch.tensornetwork.tensor import LeafTensor
    >>> from tnc_tpu_torch.tensornetwork.tensordata import TensorData
    >>> import numpy as np
    >>> t = LeafTensor([5, 3], [2, 4],
    ...     TensorData.matrix(np.arange(8.0).reshape(2, 4)))
    >>> Permutor([3, 5]).apply(t).bond_dims
    [4, 2]
    >>> Permutor([]).is_identity()
    True
    """

    def __init__(self, target_leg_order: Sequence[EdgeIndex]) -> None:
        self.target_leg_order = list(target_leg_order)

    def is_identity(self) -> bool:
        return not self.target_leg_order

    def apply(self, tensor: LeafTensor) -> LeafTensor:
        if self.is_identity():
            return tensor
        if sorted(tensor.legs) != sorted(self.target_leg_order):
            raise ValueError(
                f"tensor legs {tensor.legs} are not a permutation of target "
                f"{self.target_leg_order}"
            )
        # axes[k] = position in `tensor.legs` of the k-th target leg
        pos = {leg: i for i, leg in enumerate(tensor.legs)}
        axes = [pos[leg] for leg in self.target_leg_order]
        data = np.transpose(tensor.data.into_data(), axes)
        bond_dims = [tensor.bond_dims[a] for a in axes]
        return LeafTensor(self.target_leg_order, bond_dims, TensorData.matrix(data))


# The computational-basis one-hot values of the ⟨0|/⟨1| (equivalently
# |0⟩/|1⟩ — they are real) kets and bras.
BASIS_STATES: dict[str, np.ndarray] = {
    "0": np.array([1.0 + 0.0j, 0.0 + 0.0j]),
    "1": np.array([0.0 + 0.0j, 1.0 + 0.0j]),
}

def _ket0() -> TensorData:
    return TensorData.matrix(BASIS_STATES["0"].copy())


def _ket1() -> TensorData:
    return TensorData.matrix(BASIS_STATES["1"].copy())


class Circuit:
    """Tensor-network circuit builder (``circuit_builder.rs:127-134``)."""

    def __init__(self) -> None:
        self.open_edges: list[EdgeIndex] = []
        self.next_edge: int = 0
        self.tensor_network = CompositeTensor()
        self._finalized = False

    def _finalize(self) -> None:
        """Finalizers consume the builder (the reference takes ``self`` by
        value); a second finalizer call would corrupt the network.
        """
        if self._finalized:
            raise RuntimeError(
                "Circuit was already converted to a network; build a new Circuit"
            )
        self._finalized = True

    def _new_edge(self) -> EdgeIndex:
        edge = self.next_edge
        self.next_edge += 1
        return edge

    def num_qubits(self) -> int:
        return len(self.open_edges)

    def allocate_register(self, size: int) -> QuantumRegister:
        """Allocate ``size`` qubits initialized to |0⟩."""
        if self._finalized:
            raise RuntimeError("Circuit was already converted to a network")
        base = self.num_qubits()
        for _ in range(size):
            edge = self._new_edge()
            self.open_edges.append(edge)
            ket = LeafTensor.from_const([edge], 2)
            ket.data = _ket0()
            self.tensor_network.push_tensor(ket)
        return QuantumRegister(base, size)

    def append_gate(self, gate: TensorData, qubits: Sequence[Qubit]) -> None:
        """Append a gate tensor acting on ``qubits``; legs = new ++ old."""
        if self._finalized:
            raise RuntimeError("Circuit was already converted to a network")
        indices = [q.index for q in qubits]
        if len(set(indices)) != len(indices):
            raise ValueError("Qubit arguments must be unique")

        old_edges = [self.open_edges[i] for i in indices]
        new_edges = [self.next_edge + k for k in range(len(indices))]
        self.next_edge += len(indices)
        for qubit_index, new_edge in zip(indices, new_edges):
            self.open_edges[qubit_index] = new_edge

        tensor = LeafTensor.from_const(new_edges + old_edges, 2)
        tensor.data = gate
        self.tensor_network.push_tensor(tensor)

    # -- finalizers --------------------------------------------------------

    def into_amplitude_network(
        self, bitstring: str | Iterable
    ) -> tuple[CompositeTensor, Permutor]:
        """Close the circuit with ⟨0|/⟨1| bras per the bitstring; ``*``
        leaves the leg open (statevector slice). Returns the network and a
        Permutor for the open legs in qubit order.

        ``bitstring`` may also be an iterable of per-qubit states
        (``0``/``1`` ints, ``"0"``/``"1"``/``"*"`` chars, or ``None``
        for an open leg — :func:`normalize_bitstring`).
        """
        bitstring = normalize_bitstring(bitstring, self.num_qubits())
        self._finalize()
        final_legs: list[EdgeIndex] = []
        for c, edge in zip(bitstring, self.open_edges):
            if c == "*":
                final_legs.append(edge)
                continue
            bra = LeafTensor.from_const([edge], 2)
            bra.data = _ket0() if c == "0" else _ket1()
            self.tensor_network.push_tensor(bra)
        return self.tensor_network, Permutor(final_legs)

    def into_statevector_network(self) -> tuple[CompositeTensor, Permutor]:
        return self.into_amplitude_network("*" * self.num_qubits())
