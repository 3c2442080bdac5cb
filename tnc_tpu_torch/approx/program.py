"""ApproxProgram: serving workloads mapped onto the boundary-MPS
contractor (the port's counterpart of ``tnc_tpu.approx.program``).

The boundary contractor (:mod:`tnc_tpu_torch.tensornetwork.approximate`)
consumes a closed 2-D grid of leaf tensors. This module flattens the
two serving workload families into that shape, with **rebindable leaf
sites** so per-request payloads swap leaf *data* without rebuilding the
grid — the same build-structure-once / rebind-per-request contract as
:mod:`tnc_tpu_torch.serve.rebind`:

- **2-D lattices**: a ``builders.peps`` sandwich through the existing
  :func:`~tnc_tpu_torch.tensornetwork.approximate.collapse_peps_sandwich`
  (:meth:`ApproxProgram.from_peps_sandwich`);
- **nearest-neighbour circuits** (line/brickwork): the amplitude
  network ⟨b|C|0⟩ flattened into a ``(depth+2) × qubits`` grid
  (:func:`circuit_to_grid` — ket row, one row per gate moment with
  two-qubit gates SVD-split across a horizontal bond, rebindable bra
  row), and the sandwich ⟨0|C†·O·C|0⟩ flattened into a
  ``(2·depth+3) × qubits`` grid (:func:`sandwich_to_grid` — ket layer,
  a rebindable per-qubit operator row, mirrored conjugate layer) which
  serves Pauli expectation values (operator row = Pauli matrices) and
  marginal probabilities (operator row = projectors / identities) from
  ONE grid for every request.

``chi`` at least the grid's exact boundary rank
(:func:`tnc_tpu_torch.approx.cost.exact_chi_bound`) makes every answer exact;
below it the :mod:`tnc_tpu_torch.approx.ladder` chi-ladder supplies the error
estimate.

>>> from tnc_tpu_torch.builders.circuit_builder import Circuit
>>> from tnc_tpu_torch.tensornetwork.tensordata import TensorData
>>> c = Circuit(); reg = c.allocate_register(2)
>>> c.append_gate(TensorData.gate("h"), [reg.qubit(0)])
>>> c.append_gate(TensorData.gate("cx"), [reg.qubit(0), reg.qubit(1)])
>>> prog = ApproxProgram.from_circuit(c)   # c is read, not consumed
>>> value, weight = prog.rebind_bits("11").contract(chi=4, backend="numpy")
>>> round(abs(value), 6), weight           # Bell state: 1/sqrt(2), exact
(0.707107, 0.0)
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Iterable, Sequence

import numpy as np

from tnc_tpu_torch.builders.circuit_builder import (
    BASIS_STATES,
    PAULI_MATRICES,
    Circuit,
    normalize_bitstring,
    observable_leaf_data,
)
from tnc_tpu_torch.tensornetwork.approximate import (
    _ELEM_BYTES,
    boundary_contract_with_weight,
)
from tnc_tpu_torch.tensornetwork.tensor import LeafTensor
from tnc_tpu_torch.tensornetwork.tensordata import TensorData

__all__ = [
    "ApproxProgram",
    "circuit_to_grid",
    "sandwich_to_grid",
]

#: one-hot projectors |0⟩⟨0| / |1⟩⟨1| for marginal operator rows
_PROJECTORS = {
    "0": np.diag([1.0 + 0.0j, 0.0 + 0.0j]),
    "1": np.diag([0.0 + 0.0j, 1.0 + 0.0j]),
}


def _leaf(legs: Sequence[int], dims: Sequence[int], arr) -> LeafTensor:
    return LeafTensor(
        list(legs),
        list(dims),
        TensorData.matrix(np.asarray(arr, dtype=np.complex128)),
    )


def _circuit_ops(circuit: Circuit):
    """Replay the builder's tensor list (kets then gates, the
    :mod:`tnc_tpu_torch.queries.statevector` discipline) into
    ``(num_qubits, [(qubit tuple, gate array), ...])`` without
    consuming the circuit."""
    if circuit._finalized:
        raise ValueError(
            "approx programs need an un-finalized circuit (copy before "
            "calling a finalizer)"
        )
    n = circuit.num_qubits()
    edge_qubit: dict[int, int] = {}
    next_ket = 0
    ops: list[tuple[tuple[int, ...], np.ndarray]] = []
    for tensor in circuit.tensor_network.tensors:
        legs = list(tensor.legs)
        if len(legs) == 1:  # an initial |0⟩ ket
            edge_qubit[legs[0]] = next_ket
            next_ket += 1
            continue
        k = len(legs) // 2
        if k > 2:
            raise ValueError(
                f"approx grids support 1- and 2-qubit gates; got a "
                f"{k}-qubit gate"
            )
        new, old = legs[:k], legs[k:]
        qubits = tuple(edge_qubit[e] for e in old)
        for e, q in zip(new, qubits):
            edge_qubit[e] = q
        arr = np.asarray(
            tensor.data.into_data(), dtype=np.complex128
        ).reshape((2,) * (2 * k))
        ops.append((qubits, arr))
    return n, ops


def _split_two_qubit(arr: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """SVD-split a two-qubit gate ``G[n0, n1, o0, o1]`` into site
    halves ``A[n0, o0, r]`` / ``B[r, n1, o1]`` over a horizontal bond
    of the gate's numerical operator-Schmidt rank (CX: 2)."""
    m = np.transpose(arr, (0, 2, 1, 3)).reshape(4, 4)
    u, s, vh = np.linalg.svd(m)
    keep = max(1, int(np.sum(s > (s[0] if s.size else 1.0) * 1e-13)))
    root = np.sqrt(s[:keep])
    a = (u[:, :keep] * root).reshape(2, 2, keep)
    b = (root[:, None] * vh[:keep]).reshape(keep, 2, 2)
    return a, b


def _schedule_moments(n: int, ops) -> list[dict]:
    """ASAP-schedule gates into moments (rows of the grid). Each moment
    maps column → ``("one", arr)`` or the ``("left", A)`` /
    ``("right", B)`` halves of a split nearest-neighbour gate."""
    avail = [0] * n
    moments: list[dict] = []
    for qubits, arr in ops:
        row = max(avail[q] for q in qubits)
        while len(moments) <= row:
            moments.append({})
        if len(qubits) == 1:
            moments[row][qubits[0]] = ("one", arr)
        else:
            q0, q1 = qubits
            if abs(q0 - q1) != 1:
                raise ValueError(
                    f"the approx tier flattens nearest-neighbour "
                    f"circuits only; a gate acts on non-adjacent qubits "
                    f"{(q0, q1)}"
                )
            if q0 > q1:  # reorder legs so axis 0 is the lower column
                arr = np.transpose(arr, (1, 0, 3, 2))
                q0, q1 = q1, q0
            a, b = _split_two_qubit(arr)
            moments[row][q0] = ("left", a)
            moments[row][q1] = ("right", b)
        for q in qubits:
            avail[q] = row + 1
    return moments


def _moment_row(
    moment: dict, wires: list[int], legno, conj: bool = False
) -> tuple[list[LeafTensor], list[int]]:
    """One grid row for a gate moment. ``wires`` are the incoming wire
    legs (from the row above); returns the row and the outgoing wires.
    ``conj=True`` builds the adjoint-mirror layer's version:
    complex-conjugated data with the wire ROLES mirrored — in the ket
    layer a gate's new (output) axis faces down the grid, in the conj
    layer it faces UP (toward the operator row), because the mirror
    computes conj(ψ)_b = Σ_i conj(G)[b, i] ket_i with b on top.
    Binding conj data with unchanged orientation would transpose every
    gate, which is invisible for symmetric gates (h/rz/cx) but wrong
    for anything else (ry, sy, ...)."""
    n = len(wires)
    row: list[LeafTensor] = []
    out_wires = list(wires)
    hlegs: dict[int, int] = {}

    def data(arr):
        return np.conj(arr) if conj else arr

    for q in range(n):
        win = wires[q]
        wout = next(legno)
        out_wires[q] = wout
        # the leg carrying the gate's NEW (output) axis vs its OLD
        # (input) axis; data arrays are stored [new..., old...]
        new_leg, old_leg = (win, wout) if conj else (wout, win)
        entry = moment.get(q)
        if entry is None:
            row.append(_leaf([new_leg, old_leg], [2, 2], np.eye(2)))
        elif entry[0] == "one":
            row.append(_leaf([new_leg, old_leg], [2, 2], data(entry[1])))
        elif entry[0] == "left":
            a = entry[1]  # [n0, o0, r]
            h = next(legno)
            hlegs[q] = h
            row.append(
                _leaf([new_leg, old_leg, h], [2, 2, a.shape[2]], data(a))
            )
        else:  # "right" — its "left" partner is column q-1
            b = entry[1]  # [r, n1, o1]
            row.append(
                _leaf(
                    [hlegs[q - 1], new_leg, old_leg],
                    [b.shape[0], 2, 2],
                    data(b),
                )
            )
    return row, out_wires


def circuit_to_grid(
    circuit: Circuit,
) -> tuple[list[list[LeafTensor]], list[LeafTensor]]:
    """Flatten a nearest-neighbour circuit's amplitude network
    ⟨b|C|0⟩ into the ``(moments+2) × qubits`` grid the boundary
    contractor consumes. Returns ``(grid, bras)`` — ``bras`` are the
    bottom-row leaves in qubit order, initialized to ⟨0| and rebindable
    per request (:meth:`ApproxProgram.rebind_bits`). The circuit is
    read, not consumed."""
    n, ops = _circuit_ops(circuit)
    if n < 1:
        raise ValueError("circuit has no qubits")
    moments = _schedule_moments(n, ops)
    legno = itertools.count()
    wires = [next(legno) for _ in range(n)]
    grid: list[list[LeafTensor]] = [
        [_leaf([wires[q]], [2], BASIS_STATES["0"]) for q in range(n)]
    ]
    for moment in moments:
        row, wires = _moment_row(moment, wires, legno)
        grid.append(row)
    bras = [_leaf([wires[q]], [2], BASIS_STATES["0"]) for q in range(n)]
    grid.append(bras)
    return grid, bras


def sandwich_to_grid(
    circuit: Circuit,
) -> tuple[list[list[LeafTensor]], list[LeafTensor]]:
    """Flatten the sandwich ⟨0|C† (O₁⊗…⊗Oₙ) C|0⟩ of a
    nearest-neighbour circuit into a ``(2·moments+3) × qubits`` grid:
    ket row, the circuit's moment rows, ONE per-qubit operator row
    (legs ``[ket wire, conj wire]``, data stored transposed via
    :func:`~tnc_tpu_torch.builders.circuit_builder.observable_leaf_data` so
    the grid value is ⟨ψ|O|ψ⟩), the conjugated moment rows mirrored in
    reverse order, and a closing ⟨0| row. Returns ``(grid, op_leaves)``
    — the operator leaves in qubit order, initialized to the identity
    and rebindable per request (Pauli strings for expectation values,
    projectors for marginal probabilities). The circuit is read, not
    consumed."""
    n, ops = _circuit_ops(circuit)
    if n < 1:
        raise ValueError("circuit has no qubits")
    moments = _schedule_moments(n, ops)
    legno = itertools.count()
    wires = [next(legno) for _ in range(n)]
    grid: list[list[LeafTensor]] = [
        [_leaf([wires[q]], [2], BASIS_STATES["0"]) for q in range(n)]
    ]
    for moment in moments:
        row, wires = _moment_row(moment, wires, legno)
        grid.append(row)
    conj_wires = [next(legno) for _ in range(n)]
    op_leaves = [
        LeafTensor(
            [wires[q], conj_wires[q]],
            [2, 2],
            observable_leaf_data(PAULI_MATRICES["i"]),
        )
        for q in range(n)
    ]
    grid.append(op_leaves)
    wires = conj_wires
    for moment in reversed(moments):
        row, wires = _moment_row(moment, wires, legno, conj=True)
        grid.append(row)
    grid.append(
        [_leaf([wires[q]], [2], BASIS_STATES["0"]) for q in range(n)]
    )
    return grid, op_leaves


@dataclass
class ApproxProgram:
    """A serving workload bound to a boundary-MPS grid.

    Built once per circuit / lattice *structure*; per-request payloads
    rebind leaf data in place (the grid and its leg structure are
    payload-independent),
    then :meth:`contract` runs one sweep at a given ``chi`` and returns
    ``(value, discarded_weight)``.
    """

    grid: list[list[LeafTensor]]
    kind: str  # "amplitude" | "sandwich" | "value"
    num_qubits: int = 0
    rebind_sites: tuple[LeafTensor, ...] = ()
    cutoff: float = 0.0
    _dims: list = field(default=None, repr=False, compare=False)
    _costs: dict = field(default_factory=dict, repr=False, compare=False)

    @classmethod
    def from_circuit(cls, circuit: Circuit) -> "ApproxProgram":
        """Amplitude program ⟨b|C|0⟩ with rebindable bras
        (nearest-neighbour circuits; the circuit is read, not
        consumed)."""
        grid, bras = circuit_to_grid(circuit)
        return cls(
            grid=grid,
            kind="amplitude",
            num_qubits=circuit.num_qubits(),
            rebind_sites=tuple(bras),
        )

    @classmethod
    def sandwich_from_circuit(cls, circuit: Circuit) -> "ApproxProgram":
        """Sandwich program ⟨ψ|O₁⊗…⊗Oₙ|ψ⟩ with a rebindable operator
        row — expectation values and marginal probabilities share this
        ONE grid."""
        grid, op_leaves = sandwich_to_grid(circuit)
        return cls(
            grid=grid,
            kind="sandwich",
            num_qubits=circuit.num_qubits(),
            rebind_sites=tuple(op_leaves),
        )

    @classmethod
    def from_peps_sandwich(
        cls, tn, length: int, depth: int, layers: int
    ) -> "ApproxProgram":
        """Closed-value program over a ``builders.peps`` sandwich (data
        attached); no rebindable sites — each contraction answers the
        one scalar the lattice defines."""
        from tnc_tpu_torch.tensornetwork.approximate import collapse_peps_sandwich

        grid = collapse_peps_sandwich(tn, length, depth, layers)
        return cls(grid=grid, kind="value")

    # -- rebinding ---------------------------------------------------------

    def rebind_bits(self, bits: str | Iterable) -> "ApproxProgram":
        """Swap the bra row to ⟨bits| (amplitude programs). Fully
        determined bitstrings only — the boundary sweep computes one
        scalar."""
        if self.kind != "amplitude":
            raise ValueError(
                f"rebind_bits applies to amplitude programs, not "
                f"{self.kind!r}"
            )
        bits = normalize_bitstring(bits, self.num_qubits)
        if "*" in bits:
            raise ValueError(
                "approx amplitude requests must be fully determined "
                "(no '*' positions)"
            )
        for leaf, c in zip(self.rebind_sites, bits):
            leaf.data = TensorData.matrix(BASIS_STATES[c].copy())
        return self

    def rebind_operators(self, mats: Sequence) -> "ApproxProgram":
        """Swap the operator row (sandwich programs): one 2×2 operator
        per qubit, ``None`` = identity."""
        if self.kind != "sandwich":
            raise ValueError(
                f"rebind_operators applies to sandwich programs, not "
                f"{self.kind!r}"
            )
        mats = list(mats)
        if len(mats) != self.num_qubits:
            raise ValueError(
                f"expected {self.num_qubits} operators, got {len(mats)}"
            )
        for q, (leaf, m) in enumerate(zip(self.rebind_sites, mats)):
            m = PAULI_MATRICES["i"] if m is None else np.asarray(m)
            if m.shape != (2, 2):
                raise ValueError(
                    f"operator for qubit {q} must be 2x2, got {m.shape}"
                )
            leaf.data = observable_leaf_data(m)
        return self

    def rebind_pauli(self, pauli: str) -> "ApproxProgram":
        """Operator row ← a Pauli string (one of ``ixyz`` per qubit)."""
        from tnc_tpu_torch.queries.statevector import normalize_pauli

        pauli = normalize_pauli(pauli, self.num_qubits)
        return self.rebind_operators([PAULI_MATRICES[c] for c in pauli])

    def rebind_projectors(self, pattern: str | Iterable) -> "ApproxProgram":
        """Operator row ← the marginal projector of ``pattern``
        (``'0'``/``'1'`` = |b⟩⟨b|, ``'*'`` = identity); the grid value
        becomes the marginal probability of the determined bits."""
        pattern = normalize_bitstring(pattern, self.num_qubits)
        return self.rebind_operators(
            [None if c == "*" else _PROJECTORS[c] for c in pattern]
        )

    # -- execution ---------------------------------------------------------

    def contract(
        self, chi: int, backend: str = "torch", dtype: str = "complex64",
        device=None,
    ) -> tuple[complex, float]:
        """One boundary sweep at ``chi``: ``(value, discarded
        weight)``. ``backend="torch"``, the default, sweeps on ``device``
        (``None``: the card, raising without CUDA) in ``dtype``;
        ``backend="numpy"`` on the host in complex128
        (:func:`~tnc_tpu_torch.tensornetwork.approximate.
        boundary_contract_with_weight`)."""
        return boundary_contract_with_weight(
            self.grid, chi, cutoff=self.cutoff, backend=backend, dtype=dtype,
            device=device,
        )

    def site_dims(self):
        """Cached grid geometry for the closed-form cost model."""
        if self._dims is None:
            from tnc_tpu_torch.tensornetwork.approximate import grid_site_dims

            self._dims = grid_site_dims(self.grid)
        return self._dims

    def sweep_cost(self, chi: int, itemsize: int = _ELEM_BYTES):
        """Memoized closed-form sweep cost at ``chi`` (bytes at
        ``itemsize`` bytes an element) — rebinding swaps
        leaf data, never geometry, so one walk per ``chi`` serves every
        request and stats scrape (the serving hot path prices rungs per
        request, and ``/metrics`` re-quotes per scrape)."""
        cost = self._costs.get((chi, itemsize))
        if cost is None:
            from tnc_tpu_torch.approx.cost import sweep_cost

            cost = sweep_cost(self.site_dims(), chi, itemsize)
            self._costs[(chi, itemsize)] = cost
        return cost
