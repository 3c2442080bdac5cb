"""Dense statevector oracle for query-engine exactness pins (the port's
copy of ``tnc_tpu.queries.statevector``; numpy only).

Every query type the engine serves — amplitudes, chain-rule sampling
conditionals, Pauli expectation values, marginal probabilities — has a
brute-force ``O(2^n)`` definition over the dense statevector. This
module computes those definitions directly from an (un-finalized)
:class:`~tnc_tpu_torch.builders.circuit_builder.Circuit`, replaying its gate
tensors against a ``(2,)*n`` state array in ``complex128``, so tests
and smoke scripts can pin the tensor-network answers against ground
truth without a second circuit description.

Conventions: qubit 0 is the MOST significant bit — ``amplitude(sv,
bits)`` reads ``sv.reshape(-1)[int(bits, 2)]`` — matching the
bitstring order of :meth:`Circuit.into_amplitude_network`.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np

from tnc_tpu_torch.builders.circuit_builder import (
    PAULI_MATRICES,
    Circuit,
    normalize_bitstring,
)


def statevector(circuit: Circuit) -> np.ndarray:
    """The dense state C|0…0⟩ of an **un-finalized** circuit as a
    ``(2,)*n`` complex128 array (axis ``q`` = qubit ``q``).

    The circuit is read, not consumed: the builder's tensor list holds
    the |0⟩ kets (one leg each, allocation order) followed by the gate
    tensors (legs = new ++ old) in append order, which is exactly a
    replay script. Use :meth:`Circuit.copy` first if you need the
    oracle AND a finalizer from one circuit.

    >>> from tnc_tpu_torch.tensornetwork.tensordata import TensorData
    >>> c = Circuit(); reg = c.allocate_register(2)
    >>> c.append_gate(TensorData.gate("x"), [reg.qubit(0)])
    >>> statevector(c).reshape(-1).tolist()
    [0j, 0j, (1+0j), 0j]
    """
    if circuit._finalized:
        raise ValueError(
            "statevector needs an un-finalized circuit (copy before "
            "calling a finalizer)"
        )
    n = circuit.num_qubits()
    state = np.zeros((2,) * n if n else (1,), dtype=np.complex128)
    state.reshape(-1)[0] = 1.0

    edge_qubit: dict[int, int] = {}
    next_ket = 0
    for tensor in circuit.tensor_network.tensors:
        legs = list(tensor.legs)
        if len(legs) == 1:  # an initial |0⟩ ket
            edge_qubit[legs[0]] = next_ket
            next_ket += 1
            continue
        k = len(legs) // 2
        new, old = legs[:k], legs[k:]
        qubits = [edge_qubit[e] for e in old]
        for e, q in zip(new, qubits):
            edge_qubit[e] = q
        gate = np.asarray(tensor.data.into_data(), dtype=np.complex128)
        # contract the gate's in-legs with the state's qubit axes; the
        # out-legs land first, then move back to the qubit positions
        out = np.tensordot(gate, state, axes=(list(range(k, 2 * k)), qubits))
        state = np.moveaxis(out, list(range(k)), qubits)
    return state


def amplitude(state: np.ndarray, bits: str | Iterable) -> complex:
    """⟨bits|state⟩ for a fully determined bitstring."""
    bits = normalize_bitstring(bits, state.ndim)
    if "*" in bits:
        raise ValueError("amplitude needs a fully determined bitstring")
    return complex(state[tuple(int(c) for c in bits)])


def marginal_probability(state: np.ndarray, pattern: str | Iterable) -> float:
    """p(determined positions of ``pattern``), the born-rule mass
    summed over every ``*`` position.

    >>> from tnc_tpu_torch.tensornetwork.tensordata import TensorData
    >>> c = Circuit(); reg = c.allocate_register(2)
    >>> c.append_gate(TensorData.gate("h"), [reg.qubit(0)])
    >>> marginal_probability(statevector(c), "0*")
    0.4999999999999999
    """
    pattern = normalize_bitstring(pattern, state.ndim)
    probs = np.abs(state) ** 2
    index = tuple(
        slice(None) if c == "*" else int(c) for c in pattern
    )
    return float(np.sum(probs[index]))


def conditional_distribution(
    state: np.ndarray, prefix: str
) -> tuple[float, float]:
    """Unnormalized chain-rule conditionals for the next qubit after a
    sampled ``prefix``: ``(p(prefix + '0'), p(prefix + '1'))`` with
    every later qubit marginalized — the dense counterpart of one
    sampler step (:mod:`tnc_tpu_torch.queries.sampling`)."""
    n = state.ndim
    k = len(prefix)
    if k >= n:
        raise ValueError(f"prefix length {k} leaves no qubit to sample")
    tail = "*" * (n - k - 1)
    return (
        marginal_probability(state, prefix + "0" + tail),
        marginal_probability(state, prefix + "1" + tail),
    )


def apply_paulis(state: np.ndarray, pauli: str) -> np.ndarray:
    """P|state⟩ for a Pauli string (one of ``ixyz`` per qubit)."""
    out = state
    for q, c in enumerate(pauli):
        if c == "i":
            continue
        out = np.moveaxis(
            np.tensordot(PAULI_MATRICES[c], out, axes=([1], [q])), 0, q
        )
    return out


def pauli_expectation(state: np.ndarray, pauli: str) -> complex:
    """⟨state|P|state⟩ by dense math (complex; imaginary part is
    roundoff for Hermitian P)."""
    return complex(
        np.vdot(state.reshape(-1), apply_paulis(state, pauli).reshape(-1))
    )


def sample_oracle(
    state: np.ndarray, n_samples: int, rng: np.random.Generator
) -> list[str]:
    """Chain-rule sampling over the dense conditionals with the SAME
    draw discipline as :class:`~tnc_tpu_torch.queries.sampling.ChainSampler`
    (one uniform vector per qubit position, sample-major) — a seeded
    oracle run and a seeded sampler run over exact-arithmetic circuits
    produce identical streams."""
    n = state.ndim
    prefixes = [""] * n_samples
    for _k in range(n):
        u = rng.random(n_samples)
        for i in range(n_samples):
            p0, p1 = conditional_distribution(state, prefixes[i])
            total = p0 + p1
            p1n = p1 / total if total > 0.0 else 0.5
            prefixes[i] += "1" if u[i] < p1n else "0"
    return prefixes


def probabilities(state: np.ndarray) -> np.ndarray:
    """|state|^2 flattened to ``(2**n,)`` (index = ``int(bits, 2)``)."""
    return (np.abs(state) ** 2).reshape(-1)


def pauli_string_matrix(pauli: str) -> np.ndarray:
    """The dense ``(2^n, 2^n)`` operator of a Pauli string (test-sized
    ``n`` only)."""
    out = np.array([[1.0 + 0.0j]])
    for c in pauli:
        out = np.kron(out, PAULI_MATRICES[c])
    return out


def normalize_pauli(pauli: str | Sequence[str], num_qubits: int) -> str:
    """Canonicalize a Pauli-string spec: lowercase, length-checked,
    alphabet ``ixyz`` (errors name the offending position).

    >>> normalize_pauli("IXz", 3)
    'ixz'
    """
    chars = [str(c).lower() for c in pauli]
    if len(chars) != num_qubits:
        raise ValueError(
            f"Pauli string length {len(chars)} != qubit count {num_qubits}"
        )
    for pos, c in enumerate(chars):
        if c not in PAULI_MATRICES:
            raise ValueError(
                f"invalid Pauli character {c!r} at position {pos} "
                "(only 'i', 'x', 'y' and 'z' are allowed)"
            )
    return "".join(chars)
