"""Quantum-circuit → tensor-network builder (the port's copy of
``tnc_tpu.builders.circuit_builder``):

- ``allocate_register(n)`` pushes |0⟩ kets, one edge each.
- ``append_gate(data, qubits)`` creates a tensor whose legs are the *new*
  output edges first, then the old input edges (``edges = new ++ old``) —
  matching the gate storage layout ``(out…, in…)``.
- Finalizers: ``into_amplitude_network(bitstring)`` (``0``/``1``/``*``
  wildcards → open legs), ``into_statevector_network()`` (all
  wildcards), ``into_expectation_value_network(observables)`` (circuit
  ++ adjoint mirror ++ one Pauli leaf per qubit), and the rebindable
  ones the serving and query layers plan once per structure:
  ``into_amplitude_template(mask)`` (placeholder bras) and
  ``into_sandwich_template(spec)`` (circuit ++ adjoint mirror,
  each qubit determined, traced, open or an observable slot). A
  template's rebindable leaves are the trailing leaves of its network,
  in qubit order.
- ``copy()`` gives an independent, un-finalized circuit, so one logical
  circuit can be finalized into several networks.
- A :class:`Permutor` restores natural qubit order after contraction,
  since the contraction can emit the open legs in any order.
"""

from __future__ import annotations

from dataclasses import dataclass
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
# |0⟩/|1⟩ — they are real) kets and bras: the one table the builder's
# leaves, the serving layer's rebound bras (:mod:`tnc_tpu_torch.serve.
# rebind`) and the sweep's stacked bras (:mod:`tnc_tpu_torch.tensornetwork.
# sweep`) all read.
BASIS_STATES: dict[str, np.ndarray] = {
    "0": np.array([1.0 + 0.0j, 0.0 + 0.0j]),
    "1": np.array([0.0 + 0.0j, 1.0 + 0.0j]),
}

# Single-qubit Pauli matrices in the gate storage layout ``[out, in]``.
PAULI_MATRICES: dict[str, np.ndarray] = {
    "i": np.eye(2, dtype=np.complex128),
    "x": np.array([[0, 1], [1, 0]], dtype=np.complex128),
    "y": np.array([[0, -1j], [1j, 0]], dtype=np.complex128),
    "z": np.array([[1, 0], [0, -1]], dtype=np.complex128),
}


def observable_leaf_data(matrix: np.ndarray) -> TensorData:
    """Leaf data for an observable ``O`` inserted between a sandwich
    network's ket and adjoint layers (legs ``[edge, edge + offset]``).

    The contraction computes ``sum_{a,b} psi_a T[a, b] conj(psi)_b``
    for leaf data ``T`` — that is ⟨ψ|Tᵀ|ψ⟩ — so the leaf stores the
    TRANSPOSE of the operator to make the network value ⟨ψ|O|ψ⟩.
    """
    return TensorData.matrix(
        np.asarray(matrix, dtype=np.complex128).T.copy()
    )

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

    def copy(self) -> "Circuit":
        """An independent, un-finalized copy of this circuit: leaf data is
        shared (finalizers only append tensors), the tensor list and the
        edge bookkeeping are fresh. The chain-rule sampler
        (:mod:`tnc_tpu_torch.queries.sampling`) finalizes one copy per
        prefix length."""
        if self._finalized:
            raise RuntimeError(
                "Circuit was already converted to a network; nothing to copy"
            )
        dup = Circuit()
        dup.open_edges = list(self.open_edges)
        dup.next_edge = self.next_edge
        dup.tensor_network = self.tensor_network.copy()
        return dup

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

    def into_amplitude_template(
        self, mask: str | Iterable | None = None
    ) -> "AmplitudeTemplate":
        """Close the circuit with *symbolic* bra placeholders — the
        serving finalizer (:mod:`tnc_tpu_torch.serve`).

        ``mask`` says only which positions are *determined* (get a bra
        leaf, its value bound per request) and which are *open* (``*``);
        any determined character (``0``/``1``) is a placeholder, so the
        structure, path and program do not depend on it. Placeholder
        bras materialize as ⟨0|, so the template's network stays
        directly executable. The bra leaves are the trailing
        ``len(determined)`` leaves of the network, in qubit order.
        """
        if mask is None:
            mask = "0" * self.num_qubits()
        mask = normalize_bitstring(mask, self.num_qubits())
        network, permutor = self.into_amplitude_network(mask)
        determined = tuple(i for i, c in enumerate(mask) if c != "*")
        return AmplitudeTemplate(
            network=network,
            permutor=permutor,
            num_qubits=len(mask),
            determined=determined,
            mask="".join("*" if c == "*" else "?" for c in mask),
        )

    def into_statevector_network(self) -> tuple[CompositeTensor, Permutor]:
        return self.into_amplitude_network("*" * self.num_qubits())

    @staticmethod
    def _tensor_adjoint(tensor: LeafTensor, leg_offset: int) -> LeafTensor:
        """Adjoint with legs half-swapped and offset
        (``circuit_builder.rs:278-297``)."""
        half = len(tensor.legs) // 2
        legs = [l + leg_offset for l in tensor.legs[half:] + tensor.legs[:half]]
        bond_dims = tensor.bond_dims[half:] + tensor.bond_dims[:half]
        return LeafTensor(legs, bond_dims, tensor.data.adjoint())

    def _mirror_adjoint(self) -> int:
        """Finalize and append the adjoint mirror of every circuit
        tensor; returns the leg ``offset`` such that qubit ``q``'s
        adjoint-layer open leg is ``self.open_edges[q] + offset``."""
        self._finalize()
        offset = self.next_edge
        adjoints = [
            self._tensor_adjoint(t, offset) for t in self.tensor_network.tensors
        ]
        self.tensor_network.push_tensors(adjoints)
        return offset

    def into_expectation_value_network(
        self, observables: str | None = None
    ) -> CompositeTensor:
        """⟨ψ|P₁⊗…⊗Pₙ|ψ⟩ network: circuit ++ adjoint mirror ++ an
        observable layer (``circuit_builder.rs:304-326``).

        ``observables``: one Pauli character per qubit (``i``/``x``/
        ``y``/``z``); default ``"z" * n`` — the reference's ⟨ψ|Z…Z|ψ⟩
        layer. ``i`` traces the qubit out (its contribution is the
        identity between the layers). The network contracts to the
        scalar expectation value (real for Hermitian observables, up to
        roundoff).
        """
        if observables is None:
            observables = "z" * self.num_qubits()
        observables = str(observables).lower()
        if len(observables) != self.num_qubits():
            raise ValueError(
                f"observable string length {len(observables)} != qubit "
                f"count {self.num_qubits()}"
            )
        for pos, c in enumerate(observables):
            if c not in PAULI_MATRICES:
                raise ValueError(
                    f"invalid observable {c!r} at position {pos} "
                    "(only 'i', 'x', 'y' and 'z' are allowed)"
                )
        offset = self._mirror_adjoint()
        for c, edge in zip(observables, self.open_edges):
            observable = LeafTensor.from_const([edge, edge + offset], 2)
            observable.data = observable_leaf_data(PAULI_MATRICES[c])
            self.tensor_network.push_tensor(observable)
        return self.tensor_network

    def into_sandwich_template(
        self, spec: str | Iterable
    ) -> "SandwichTemplate":
        """Close the circuit ++ adjoint mirror *sandwich* with one
        closure per qubit — the query finalizer
        (:mod:`tnc_tpu_torch.queries`). ``spec`` gives one character per
        qubit:

        - ``?`` — **determined**: placeholder ⟨b| bras on BOTH layers,
          rebound per request;
        - ``*`` — **marginalized**: the ket-layer leg traced against its
          adjoint-layer mirror (an identity leaf);
        - ``o`` — **open**: both legs stay open (a ``(2, 2)`` density
          block whose diagonal is the pair of marginal probabilities);
        - ``p`` — **observable placeholder**: one rebindable 2×2 leaf
          between the layers (identity until rebound; stored as
          :func:`observable_leaf_data` stores it).

        The rebindable leaves are the TRAILING leaves of the network, in
        qubit order — for each ``?`` qubit the ket-layer bra then the
        adjoint-layer bra, one leaf per ``p`` qubit. ``?`` and ``p``
        cannot be mixed in one template.
        """
        spec = "".join(spec)
        if len(spec) != self.num_qubits():
            raise ValueError(
                f"sandwich spec length {len(spec)} != qubit count "
                f"{self.num_qubits()}"
            )
        for pos, c in enumerate(spec):
            if c not in "?*op":
                raise ValueError(
                    f"invalid sandwich spec character {c!r} at position "
                    f"{pos} (only '?', '*', 'o' and 'p' are allowed)"
                )
        if "?" in spec and "p" in spec:
            raise ValueError(
                "a sandwich template is either bra-rebindable ('?') or "
                "observable-rebindable ('p'), not both"
            )
        offset = self._mirror_adjoint()
        open_legs: list[EdgeIndex] = []
        determined: list[int] = []
        rebind: list[LeafTensor] = []
        for q, (c, edge) in enumerate(zip(spec, self.open_edges)):
            if c == "*":
                trace = LeafTensor.from_const([edge, edge + offset], 2)
                trace.data = observable_leaf_data(PAULI_MATRICES["i"])
                self.tensor_network.push_tensor(trace)
            elif c == "o":
                open_legs.extend((edge, edge + offset))
            elif c == "?":
                for leg in (edge, edge + offset):
                    bra = LeafTensor.from_const([leg], 2)
                    bra.data = _ket0()
                    rebind.append(bra)
                determined.extend((q, q))
            else:  # 'p'
                op = LeafTensor.from_const([edge, edge + offset], 2)
                op.data = observable_leaf_data(PAULI_MATRICES["i"])
                rebind.append(op)
                determined.append(q)
        self.tensor_network.push_tensors(rebind)
        return SandwichTemplate(
            network=self.tensor_network,
            permutor=Permutor(open_legs),
            num_qubits=len(spec),
            determined=tuple(determined),
            spec=spec,
        )


@dataclass(frozen=True)
class AmplitudeTemplate:
    """A circuit closed with symbolic bras (``into_amplitude_template``).

    ``network`` is a normal amplitude network whose trailing
    ``len(determined)`` leaves are placeholder bras (one per determined
    qubit, in qubit order); ``determined`` are the qubit positions that
    carry a bra, the rest are open legs. A request bitstring supplies
    one ``0``/``1`` per determined position and ``*`` at every open one.
    """

    network: CompositeTensor
    permutor: Permutor
    num_qubits: int
    determined: tuple[int, ...]
    mask: str  # '?' per determined position, '*' per open one

    @property
    def open_positions(self) -> frozenset[int]:
        """Positions with no bra (computed once per template)."""
        cached = getattr(self, "_open_positions", None)
        if cached is None:
            cached = frozenset(range(self.num_qubits)) - frozenset(
                self.determined
            )
            object.__setattr__(self, "_open_positions", cached)
        return cached

    def normalize_request(self, bitstring: str | Iterable) -> str:
        """Validate a request against the template and return it as a
        canonical full-length ``str`` (a one-shot iterable is consumed
        here once)."""
        bits = normalize_bitstring(bitstring, self.num_qubits)
        open_set = self.open_positions
        for pos, c in enumerate(bits):
            if pos in open_set and c != "*":
                raise ValueError(
                    f"position {pos} is an open leg in this template; "
                    f"request must use '*' there, got {c!r}"
                )
            if pos not in open_set and c == "*":
                raise ValueError(
                    f"position {pos} is determined in this template; "
                    "request must supply '0' or '1' there"
                )
        return bits

    def request_bits(self, bitstring: str | Iterable) -> str:
        """The determined positions' bits of a validated request (a
        ``len(self.determined)``-char ``0``/``1`` string, qubit order)."""
        bits = self.normalize_request(bitstring)
        return "".join(bits[p] for p in self.determined)


@dataclass(frozen=True)
class SandwichTemplate:
    """A circuit ++ adjoint sandwich closed with rebindable leaves
    (:meth:`Circuit.into_sandwich_template`).

    The trailing ``len(determined)`` leaves of ``network`` are the
    rebindable slots, as in :class:`AmplitudeTemplate`, so
    :func:`tnc_tpu_torch.serve.rebind.bind_template` plans and binds it
    unchanged. ``determined[i]`` is the qubit slot ``i`` serves: a ``?``
    qubit has TWO consecutive slots (ket-layer bra, then its mirror), a
    ``p`` qubit one observable slot.
    """

    network: CompositeTensor
    permutor: Permutor
    num_qubits: int
    determined: tuple[int, ...]  # one qubit index per rebindable slot
    spec: str  # per-qubit '?', '*', 'o' or 'p'

    @property
    def bra_qubits(self) -> tuple[int, ...]:
        """The determined ('?') qubit positions, in qubit order."""
        return tuple(q for q, c in enumerate(self.spec) if c == "?")

    @property
    def observable_qubits(self) -> tuple[int, ...]:
        """The observable-placeholder ('p') positions, in qubit order."""
        return tuple(q for q, c in enumerate(self.spec) if c == "p")

    def request_bits(self, bits: str | Iterable) -> str:
        """Per-slot bra bits for a request that fixes each determined
        qubit: one ``0``/``1`` per ``?`` qubit, in qubit order, doubled
        per slot (both layers carry the same one-hot value — the bras
        are real). The :class:`~tnc_tpu_torch.serve.rebind.BoundProgram`
        dispatch contract.

        >>> c = Circuit(); _ = c.allocate_register(3)
        >>> c.into_sandwich_template("??*").request_bits("01")
        '0011'
        """
        bits = normalize_bitstring(bits, len(self.bra_qubits))
        for pos, c in enumerate(bits):
            if c == "*":
                raise ValueError(
                    f"sandwich request bit {pos} must be '0' or '1' "
                    "(wildcards are fixed by the template spec)"
                )
        return "".join(c + c for c in bits)
