"""Pauli-string expectation values over sandwich networks (the port's
counterpart of ``tnc_tpu.queries.expectation``).

⟨ψ|P|ψ⟩ for a Pauli string ``P = P₁⊗…⊗Pₙ`` is one contraction of the
circuit ++ adjoint sandwich with the Pauli operators inserted between
the layers (:meth:`~tnc_tpu_torch.builders.circuit_builder.Circuit.
into_expectation_value_network`). Every Pauli string shares the SAME
network structure — only the 2×2 observable leaf values differ — so
this module treats the observable layer exactly like the serving
layer treats bras: the structure plans once
(:func:`~tnc_tpu_torch.serve.rebind.bind_template` on an
observable-placeholder :class:`~tnc_tpu_torch.builders.circuit_builder.
SandwichTemplate`) and the terms of a Pauli sum stack along a batch leg
into ONE dispatch (:mod:`tnc_tpu_torch.ops.batched`).

:meth:`ExpectationProgram.values` dispatches, counted in
:data:`DISPATCH` by mode:

- ``batched`` — :class:`~tnc_tpu_torch.ops.backends.TorchBackend` (split
  or native) or :class:`~tnc_tpu_torch.ops.backends.NumpyBackend`: one
  ``execute_batched`` over the stacked observables;
- ``sliced`` — a structure planned under a ``target_size`` it exceeds:
  one slice-summed run per term.

The reference's third mode, one ``execute`` per term for a backend
without a batched runner, has no counterpart: both of the port's
backends have ``execute_batched``.

Gradients (:func:`pauli_expectation_value_and_grad`) run through
``torch.autograd`` on the native complex batched runner
(:func:`~tnc_tpu_torch.ops.batched.run_steps_batched`): both circuit
layers carry a parameterized gate (the ket-layer leaf and its adjoint
mirror), and the cotangent convention ``df = Re(sum(g * dT))`` of
:mod:`tnc_tpu_torch.ops.autodiff` composes them into d/dθ via the chain
rule.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from tnc_tpu_torch.builders.circuit_builder import (
    PAULI_MATRICES,
    Circuit,
    SandwichTemplate,
    observable_leaf_data,
)
from tnc_tpu_torch.queries.statevector import normalize_pauli

__all__ = [
    "DISPATCH",
    "ExpectationProgram",
    "bind_expectation",
    "normalize_terms",
    "pauli_expectation",
    "pauli_sum_expectation",
    "pauli_expectation_value_and_grad",
    "reset_dispatch",
]

#: dispatches of :meth:`ExpectationProgram.values`, by mode (``batched``,
#: ``sliced``)
DISPATCH: dict[str, int] = {}


def reset_dispatch() -> None:
    """Zero :data:`DISPATCH`."""
    DISPATCH.clear()


def _count(mode: str) -> None:
    DISPATCH[mode] = DISPATCH.get(mode, 0) + 1


def stacked_observables(paulis: Sequence[str]) -> np.ndarray:
    """Observable leaf values for a batch of Pauli strings:
    ``(B, n, 2, 2)`` in qubit order, in the sandwich leaf layout —
    values come from the ONE layout rule (:func:`~tnc_tpu_torch.builders.
    circuit_builder.observable_leaf_data`, which stores the operator
    transpose), so the batched rebind path can never skew from the
    template networks.

    >>> stacked_observables(["zx"]).shape
    (1, 2, 2, 2)
    """
    return np.stack([
        np.stack([observable_leaf_data(PAULI_MATRICES[c]).into_data() for c in pauli])
        for pauli in paulis
    ])


def normalize_terms(
    terms, num_qubits: int
) -> tuple[tuple[complex, str], ...]:
    """Canonicalize a Pauli-sum spec: an iterable of ``(coeff, pauli)``
    pairs (or a bare Pauli string = one unit-coefficient term).

    >>> normalize_terms("ZI", 2)
    (((1+0j), 'zi'),)
    """
    if isinstance(terms, str):
        terms = [(1.0, terms)]
    out = []
    for coeff, pauli in terms:
        out.append((complex(coeff), normalize_pauli(pauli, num_qubits)))
    if not out:
        raise ValueError("a Pauli sum needs at least one term")
    return tuple(out)


class ExpectationProgram:
    """A planned sandwich program with rebindable observable leaves —
    the ⟨ψ|P|ψ⟩ counterpart of :class:`~tnc_tpu_torch.serve.rebind.
    BoundProgram` (which it wraps: same planning and slicing machinery;
    only the rebound leaf values differ)."""

    def __init__(self, bound) -> None:
        template: SandwichTemplate = bound.template
        if "?" in template.spec:
            raise ValueError(
                "expectation programs rebind observables, not bras "
                "(template spec must be all 'p')"
            )
        self.bound = bound
        self.num_qubits = template.num_qubits

    def values(
        self, paulis: Sequence[str], backend=None
    ) -> np.ndarray:
        """⟨ψ|P|ψ⟩ for every Pauli string, one batched dispatch
        (complex ``(B,)``; imaginary parts are roundoff for the
        Hermitian Pauli alphabet). ``backend=None`` is
        :class:`~tnc_tpu_torch.ops.backends.TorchBackend` on the card,
        which raises without CUDA."""
        from tnc_tpu_torch.ops.backends import TorchBackend
        from tnc_tpu_torch.ops.batched import stacked_rows

        paulis = [normalize_pauli(p, self.num_qubits) for p in paulis]
        if not paulis:
            return np.zeros((0,), dtype=np.complex128)
        bound = self.bound
        if backend is None:
            backend = TorchBackend()
        slots = bound.bra_slots  # observable slots (shared slot contract)
        stacked = stacked_observables(paulis)  # (B, n, 2, 2)
        buffers = list(bound.arrays)
        for i, slot in enumerate(slots):
            buffers[slot] = np.ascontiguousarray(stacked[:, i])
        b = len(paulis)
        if bound.sliced is not None:
            # budget-sliced structures run the slice loop per term
            _count("sliced")
            rows = stacked_rows(
                lambda per: backend.execute_sliced(bound.sliced, per),
                buffers, slots, b, bound.program.result_shape,
            )
        else:
            _count("batched")
            rows = backend.execute_batched(bound.program, buffers, slots)
        return np.asarray(rows).reshape(b).astype(np.complex128)

    def pauli_sum(
        self, terms, backend=None
    ) -> tuple[complex, np.ndarray]:
        """``(sum_t coeff_t ⟨ψ|P_t|ψ⟩, per-term values)`` — the terms
        share this one structure and batch like bras."""
        terms = normalize_terms(terms, self.num_qubits)
        vals = self.values([p for _, p in terms], backend)
        total = complex(sum(c * v for (c, _), v in zip(terms, vals)))
        return total, vals


def bind_expectation(
    circuit: Circuit,
    pathfinder=None,
    plan_cache=None,
    target_size: float | None = None,
) -> ExpectationProgram:
    """Plan the observable-placeholder sandwich of ``circuit``
    (consumed — finalizer semantics; ``copy()`` first to keep it). A
    ``plan_cache`` hit plans nothing
    (:func:`~tnc_tpu_torch.serve.rebind.bind_template`)."""
    from tnc_tpu_torch.serve.rebind import bind_template

    template = circuit.into_sandwich_template("p" * circuit.num_qubits())
    return ExpectationProgram(
        bind_template(template, pathfinder, plan_cache, target_size)
    )


def pauli_expectation(
    circuit: Circuit,
    pauli: str,
    pathfinder=None,
    backend=None,
    plan_cache=None,
    target_size: float | None = None,
) -> complex:
    """⟨ψ|P|ψ⟩ for one Pauli string (``circuit`` consumed).
    ``backend=None`` is ``TorchBackend()`` on the card.

    >>> from tnc_tpu_torch.ops.backends import NumpyBackend
    >>> from tnc_tpu_torch.tensornetwork.tensordata import TensorData
    >>> c = Circuit(); reg = c.allocate_register(2)
    >>> c.append_gate(TensorData.gate("x"), [reg.qubit(0)])
    >>> pauli_expectation(c, "zi", backend=NumpyBackend())
    (-1+0j)
    """
    prog = bind_expectation(circuit, pathfinder, plan_cache, target_size)
    return complex(prog.values([pauli], backend)[0])


def pauli_sum_expectation(
    circuit: Circuit,
    terms,
    pathfinder=None,
    backend=None,
    plan_cache=None,
    target_size: float | None = None,
) -> complex:
    """``sum_t coeff_t ⟨ψ|P_t|ψ⟩`` with every term sharing one planned
    sandwich structure and one batched dispatch (``circuit``
    consumed; ``backend=None`` is ``TorchBackend()`` on the card)."""
    prog = bind_expectation(circuit, pathfinder, plan_cache, target_size)
    total, _vals = prog.pauli_sum(terms, backend)
    return total


def pauli_expectation_value_and_grad(
    circuit: Circuit,
    terms,
    wrt: Sequence[int] | None = None,
    dtype: str = "complex64",
    device=None,
):
    """Value and gradient of ``f = Re(sum_t coeff_t ⟨ψ|P_t|ψ⟩)`` w.r.t.
    selected sandwich leaf tensors, through ``torch.autograd``
    (``circuit`` consumed).

    The terms batch along the observable leaves exactly like the forward
    path (one structure, one program,
    :func:`~tnc_tpu_torch.ops.batched.run_steps_batched`). ``wrt`` indexes
    the sandwich's flat leaf order — the first ``L`` slots are the
    circuit layer (kets then gates, build order), the next ``L`` their
    adjoint mirrors, and the trailing ``n`` the observable slots (which
    carry the batch leg and cannot be differentiated here); the default
    differentiates every circuit-layer AND adjoint-layer gate leaf. A
    parameterized gate θ appears in BOTH layers: with ``g_ket`` and
    ``g_adj`` the two cotangents, ``df/dθ = Re(sum(g_ket * dG/dθ)) +
    Re(sum(g_adj * d(G†)/dθ))`` (cotangent convention of
    :mod:`tnc_tpu_torch.ops.autodiff`). ``device=None`` means
    ``"cuda"`` (raises without CUDA, TF32 off).

    Returns ``(value, per_term_values, grads)`` where ``value`` is the
    real scalar and ``grads[i]`` is the cotangent for ``wrt[i]``.
    """
    import torch

    from tnc_tpu_torch.ops.autodiff import (
        _validate_wrt,
        cotangents,
        grad_of,
        leaf_tensors,
    )
    from tnc_tpu_torch.ops.backends import _complex_dtype, resolve_device
    from tnc_tpu_torch.ops.batched import run_steps_batched, thread_batch
    from tnc_tpu_torch.ops.program import flat_leaf_tensors
    from tnc_tpu_torch.serve.rebind import plan_structure

    device = resolve_device(device, "pauli_expectation_value_and_grad")
    n = circuit.num_qubits()
    n_circuit = len(circuit.tensor_network.tensors)
    terms = normalize_terms(terms, n)
    template = circuit.into_sandwich_template("p" * n)
    tn = template.network
    leaves = flat_leaf_tensors(tn)
    obs_slots = list(range(len(leaves) - n, len(leaves)))
    obs_set = set(obs_slots)

    _path, _slicing, program, _sliced, _result = plan_structure(tn)
    if wrt is None:
        # every gate leaf, both layers (kets and observables excluded)
        wrt = [s for s in range(2 * n_circuit) if len(leaves[s].legs) > 1]
    wrt = _validate_wrt(wrt, len(leaves))
    for s in wrt:
        if s in obs_set:
            raise ValueError(
                "observable slots carry the Pauli-term batch leg; "
                "not differentiable here"
            )
    arrays = leaf_tensors([leaf.data.into_data() for leaf in leaves], wrt, dtype, device)
    ctype = _complex_dtype(dtype)
    coeffs = torch.tensor([c for c, _ in terms], dtype=ctype, device=device)
    stacked = torch.from_numpy(stacked_observables([p for _, p in terms])).to(
        device=device, dtype=ctype)  # (B, n, 2, 2)
    for i, slot in enumerate(obs_slots):
        arrays[slot] = stacked[:, i]
    flags, _ = thread_batch(program, obs_slots)
    with torch.enable_grad():
        vals = run_steps_batched(program, list(arrays), flags).reshape(-1)
        value = torch.sum(torch.real(coeffs * vals))
        grads = grad_of(value, [arrays[s] for s in wrt])
    return (
        float(value.detach()),
        vals.detach().cpu().numpy().reshape(len(terms)),
        cotangents(grads),
    )
