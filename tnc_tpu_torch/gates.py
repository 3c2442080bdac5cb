"""Quantum gate library (the port's copy of ``tnc_tpu.gates``).

Mirror of ``tnc/src/gates.rs``: a global registry of named gates, each a
function of angles returning a complex tensor. One-qubit gates are ``(2,2)``
matrices ``[out, in]``; two-qubit gates are stored shape ``(2,2,2,2)`` =
``(out_a, out_b, in_a, in_b)`` (``gates.rs:419-427``). The default adjoint
is the conjugate-transpose with the half-dims-swap convention
(``gates.rs:112-126``); rotation-like gates specialize it by negating
angles.

The 18 built-ins match ``gates.rs:17-38``: x, y, z, h, t, u, sx, sy, sz,
rx, ry, rz, cx, cz, swap, cp, iswap, fsim. User gates are registered with
:func:`register_gate` (lowercase names enforced, ``gates.rs:41-47``).
"""

from __future__ import annotations

import cmath
import math
from typing import Callable, Sequence

import numpy as np

from tnc_tpu_torch.tensornetwork.tensordata import matrix_adjoint

GateFn = Callable[..., np.ndarray]

_C = np.complex128


def _check_angles(name: str, angles: Sequence[float], n: int) -> None:
    if len(angles) != n:
        raise ValueError(f"Gate '{name}': expected {n} angles, but got {len(angles)}.")


def _two_qubit(matrix: np.ndarray) -> np.ndarray:
    """Reshape a 4x4 matrix to the (2,2,2,2) storage layout."""
    return matrix.reshape(2, 2, 2, 2)


# -- gate definitions (gates.rs:150-555) -----------------------------------

_SQ2 = 1.0 / math.sqrt(2.0)


def _gate_x(angles: Sequence[float]) -> np.ndarray:
    _check_angles("x", angles, 0)
    return np.array([[0, 1], [1, 0]], dtype=_C)


def _gate_y(angles: Sequence[float]) -> np.ndarray:
    _check_angles("y", angles, 0)
    return np.array([[0, -1j], [1j, 0]], dtype=_C)


def _gate_z(angles: Sequence[float]) -> np.ndarray:
    _check_angles("z", angles, 0)
    return np.array([[1, 0], [0, -1]], dtype=_C)


def _gate_h(angles: Sequence[float]) -> np.ndarray:
    _check_angles("h", angles, 0)
    return np.array([[_SQ2, _SQ2], [_SQ2, -_SQ2]], dtype=_C)


def _gate_t(angles: Sequence[float]) -> np.ndarray:
    _check_angles("t", angles, 0)
    return np.array([[1, 0], [0, complex(_SQ2, _SQ2)]], dtype=_C)


def _gate_u(angles: Sequence[float]) -> np.ndarray:
    """OpenQASM-3 u(theta, phi, lambda) (gates.rs:252-272)."""
    _check_angles("u", angles, 3)
    theta, phi, lam = angles
    s, c = math.sin(theta / 2.0), math.cos(theta / 2.0)
    return np.array(
        [
            [c, -cmath.exp(1j * lam) * s],
            [cmath.exp(1j * phi) * s, cmath.exp(1j * (phi + lam)) * c],
        ],
        dtype=_C,
    )


def _gate_sx(angles: Sequence[float]) -> np.ndarray:
    _check_angles("sx", angles, 0)
    a, b = complex(0.5, 0.5), complex(0.5, -0.5)
    return np.array([[a, b], [b, a]], dtype=_C)


def _gate_sy(angles: Sequence[float]) -> np.ndarray:
    _check_angles("sy", angles, 0)
    a, b = complex(0.5, 0.5), complex(-0.5, -0.5)
    return np.array([[a, b], [a, a]], dtype=_C)


def _gate_sz(angles: Sequence[float]) -> np.ndarray:
    _check_angles("sz", angles, 0)
    return np.array([[1, 0], [0, 1j]], dtype=_C)


def _gate_rx(angles: Sequence[float]) -> np.ndarray:
    _check_angles("rx", angles, 1)
    s, c = math.sin(angles[0] / 2.0), math.cos(angles[0] / 2.0)
    return np.array([[c, -1j * s], [-1j * s, c]], dtype=_C)


def _gate_ry(angles: Sequence[float]) -> np.ndarray:
    _check_angles("ry", angles, 1)
    s, c = math.sin(angles[0] / 2.0), math.cos(angles[0] / 2.0)
    return np.array([[c, -s], [s, c]], dtype=_C)


def _gate_rz(angles: Sequence[float]) -> np.ndarray:
    _check_angles("rz", angles, 1)
    theta = angles[0]
    return np.array(
        [[cmath.exp(-1j * theta / 2.0), 0], [0, cmath.exp(1j * theta / 2.0)]], dtype=_C
    )


def _gate_cx(angles: Sequence[float]) -> np.ndarray:
    _check_angles("cx", angles, 0)
    m = np.array(
        [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0, 1], [0, 0, 1, 0]], dtype=_C
    )
    return _two_qubit(m)


def _gate_cz(angles: Sequence[float]) -> np.ndarray:
    _check_angles("cz", angles, 0)
    m = np.diag(np.array([1, 1, 1, -1], dtype=_C))
    return _two_qubit(m)


def _gate_swap(angles: Sequence[float]) -> np.ndarray:
    _check_angles("swap", angles, 0)
    m = np.array(
        [[1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], dtype=_C
    )
    return _two_qubit(m)


def _gate_cp(angles: Sequence[float]) -> np.ndarray:
    _check_angles("cp", angles, 1)
    m = np.diag(np.array([1, 1, 1, cmath.exp(1j * angles[0])], dtype=_C))
    return _two_qubit(m)


def _gate_iswap(angles: Sequence[float]) -> np.ndarray:
    _check_angles("iswap", angles, 0)
    m = np.array(
        [[1, 0, 0, 0], [0, 0, 1j, 0], [0, 1j, 0, 0], [0, 0, 0, 1]], dtype=_C
    )
    return _two_qubit(m)


def _gate_fsim(angles: Sequence[float]) -> np.ndarray:
    """FSIM(theta, phi) as in cirq (gates.rs:530-548)."""
    _check_angles("fsim", angles, 2)
    theta, phi = angles
    a = complex(math.cos(theta), 0.0)
    b = complex(0.0, -math.sin(theta))
    c = cmath.exp(complex(0.0, -phi))
    m = np.array(
        [[1, 0, 0, 0], [0, a, b, 0], [0, b, a, 0], [0, 0, 0, c]], dtype=_C
    )
    return _two_qubit(m)


def _negated_angles_adjoint(fn: GateFn) -> GateFn:
    """Adjoint by negating all angles (rotation-like gates)."""

    def adjoint(angles: Sequence[float]) -> np.ndarray:
        return fn([-a for a in angles])

    return adjoint


def _conjugate_adjoint(fn: GateFn) -> GateFn:
    """Adjoint by elementwise conjugation (symmetric matrices)."""

    def adjoint(angles: Sequence[float]) -> np.ndarray:
        return np.conj(fn(angles))

    return adjoint


class Gate:
    """A named gate: compute(angles) -> tensor, adjoint(angles) -> tensor.

    ``arity`` (qubit count) is optional; when set, frontends validate the
    number of qubit arguments at call sites.
    """

    __slots__ = ("name", "compute", "_adjoint", "arity")

    def __init__(
        self,
        name: str,
        compute: GateFn,
        adjoint: GateFn | None = None,
        arity: int | None = None,
    ):
        self.name = name
        self.compute = compute
        self._adjoint = adjoint
        self.arity = arity

    def adjoint(self, angles: Sequence[float]) -> np.ndarray:
        if self._adjoint is not None:
            return self._adjoint(angles)
        return matrix_adjoint(self.compute(angles))


def _u_adjoint(angles: Sequence[float]) -> np.ndarray:
    _check_angles("u", angles, 3)
    theta, phi, lam = angles
    s, c = math.sin(theta / 2.0), math.cos(theta / 2.0)
    return np.array(
        [
            [c, cmath.exp(-1j * phi) * s],
            [-cmath.exp(-1j * lam) * s, cmath.exp(-1j * (phi + lam)) * c],
        ],
        dtype=_C,
    )


_GATES: dict[str, Gate] = {}


def register_gate(gate: Gate) -> None:
    """Register a gate; name must be lowercase (``gates.rs:41-47``)."""
    if gate.name != gate.name.lower():
        raise ValueError(f"Gate names must be lowercase, got '{gate.name}'")
    if gate.name in _GATES:
        raise ValueError(f"Gate '{gate.name}' is already registered")
    _GATES[gate.name] = gate


def _register_builtins() -> None:
    builtins = [
        Gate("x", _gate_x, _gate_x, 1),
        Gate("y", _gate_y, _gate_y, 1),
        Gate("z", _gate_z, _gate_z, 1),
        Gate("h", _gate_h, _gate_h, 1),
        Gate("t", _gate_t, _conjugate_adjoint(_gate_t), 1),
        Gate("u", _gate_u, _u_adjoint, 1),
        Gate("sx", _gate_sx, _conjugate_adjoint(_gate_sx), 1),
        # sy is asymmetric: generic conjugate-transpose adjoint
        Gate("sy", _gate_sy, None, 1),
        Gate("sz", _gate_sz, _conjugate_adjoint(_gate_sz), 1),
        Gate("rx", _gate_rx, _negated_angles_adjoint(_gate_rx), 1),
        Gate("ry", _gate_ry, _negated_angles_adjoint(_gate_ry), 1),
        Gate("rz", _gate_rz, _negated_angles_adjoint(_gate_rz), 1),
        Gate("cx", _gate_cx, _gate_cx, 2),
        Gate("cz", _gate_cz, _gate_cz, 2),
        Gate("swap", _gate_swap, _gate_swap, 2),
        Gate("cp", _gate_cp, _negated_angles_adjoint(_gate_cp), 2),
        Gate("iswap", _gate_iswap, _conjugate_adjoint(_gate_iswap), 2),
        Gate("fsim", _gate_fsim, _negated_angles_adjoint(_gate_fsim), 2),
    ]
    for g in builtins:
        register_gate(g)


_register_builtins()


def is_gate_known(name: str) -> bool:
    """Is ``name`` in the registry (``gates.rs:70-74``)?

    >>> is_gate_known("h"), is_gate_known("nonsense")
    (True, False)
    """
    return name in _GATES


def load_gate(name: str, angles: Sequence[float] = ()) -> np.ndarray:
    """Materialize a registered gate's matrix (``gates.rs:51-57``).

    >>> import numpy as np
    >>> np.allclose(load_gate("x"), [[0, 1], [1, 0]])
    True
    >>> load_gate("rz", [0.0]).shape
    (2, 2)
    """
    if name not in _GATES:
        raise KeyError(f"Gate '{name}' not found.")
    return _GATES[name].compute(angles)


def load_gate_adjoint(name: str, angles: Sequence[float] = ()) -> np.ndarray:
    if name not in _GATES:
        raise KeyError(f"Gate '{name}' not found.")
    return _GATES[name].adjoint(angles)


def gate_arity(name: str) -> int | None:
    """Qubit count of a registered gate, if declared.

    >>> gate_arity("h"), gate_arity("fsim"), gate_arity("nonsense")
    (1, 2, None)
    """
    gate = _GATES.get(name)
    return gate.arity if gate is not None else None


def gate_names() -> list[str]:
    return sorted(_GATES)
