"""Marginal-probability sweeps: wildcard bitstring patterns as
first-class queries (the port's counterpart of
``tnc_tpu.queries.marginal``).

An open leg in a single-layer amplitude network yields a statevector
*slice*, exponential in the number of wildcards. The marginal sweep
contracts the circuit ++ adjoint *sandwich* in which every wildcard
position's leg is traced against its mirror
(:meth:`~tnc_tpu_torch.builders.circuit_builder.Circuit.
into_sandwich_template` spec ``'*'``), so the network computes
``p(determined bits) = Σ_wildcards |⟨b|C|0…0⟩|²`` directly — cost is
one scalar contraction per pattern, independent of how many positions
are marginalized.

All patterns of a sweep must share one wildcard MASK (the mask is the
structure; the determined bits are bra values) — the batch rebinds
through one planned program exactly like amplitude serving
(:mod:`tnc_tpu_torch.serve.rebind`).
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np

from tnc_tpu_torch.builders.circuit_builder import Circuit, normalize_bitstring

__all__ = [
    "marginal_sweep",
    "marginal_probabilities",
    "bind_marginal",
    "wildcard_mask",
]


def wildcard_mask(pattern: str) -> str:
    """The structure-defining mask of a pattern: ``'?'`` per determined
    position, ``'*'`` per wildcard.

    >>> wildcard_mask("0*1")
    '?*?'
    """
    return "".join("*" if c == "*" else "?" for c in pattern)


def bind_marginal(
    circuit: Circuit,
    mask: str,
    pathfinder=None,
    plan_cache=None,
    target_size: float | None = None,
):
    """Plan/compile the marginal sandwich for one wildcard ``mask``
    (``'?'``/``'*'`` per qubit; ``circuit`` consumed). Returns the
    :class:`~tnc_tpu_torch.serve.rebind.BoundProgram`; each query rebinds
    the determined positions' bras; a ``plan_cache`` hit plans nothing
    (:func:`~tnc_tpu_torch.serve.rebind.bind_template`)."""
    from tnc_tpu_torch.serve.rebind import bind_template

    template = circuit.into_sandwich_template(mask)
    return bind_template(template, pathfinder, plan_cache, target_size)


def marginal_probabilities(
    bound, patterns: Sequence[str], backend=None
) -> np.ndarray:
    """Marginal probabilities for patterns sharing ``bound``'s mask —
    one batched dispatch; real ``(B,)``, clipped at 0 (a marginal is a
    born-rule mass; tiny negative roundoff must not leak to callers).
    ``backend=None`` is ``TorchBackend()`` on the card
    (:meth:`~tnc_tpu_torch.serve.rebind.BoundProgram.amplitudes_det`)."""
    template = bound.template
    bra_qubits = template.bra_qubits
    batch = []
    for pattern in patterns:
        bits = normalize_bitstring(pattern, template.num_qubits)
        if wildcard_mask(bits) != template.spec:
            raise ValueError(
                f"pattern {bits!r} does not match this sweep's wildcard "
                f"mask {template.spec!r}"
            )
        batch.append(
            template.request_bits("".join(bits[q] for q in bra_qubits))
        )
    out = bound.amplitudes_det(batch, backend)
    return np.clip(np.real(out).reshape(len(patterns)), 0.0, None)


def marginal_sweep(
    circuit: Circuit,
    patterns: Sequence[str | Iterable],
    pathfinder=None,
    backend=None,
    plan_cache=None,
    target_size: float | None = None,
) -> np.ndarray:
    """Marginal probabilities of the determined positions for every
    pattern, sharing one path and one compiled sandwich program
    (``circuit`` is consumed — finalizer semantics, matching
    :func:`~tnc_tpu_torch.tensornetwork.sweep.amplitude_sweep`, which
    delegates its wildcard case here). All patterns must carry the
    same wildcard mask. Returns a real ``(len(patterns),)`` array.
    ``backend=None`` is ``TorchBackend()`` on the card.

    >>> from tnc_tpu_torch.ops.backends import NumpyBackend
    >>> from tnc_tpu_torch.tensornetwork.tensordata import TensorData
    >>> c = Circuit(); reg = c.allocate_register(2)
    >>> c.append_gate(TensorData.gate("x"), [reg.qubit(0)])
    >>> marginal_sweep(c, ["0*", "1*"], backend=NumpyBackend()).tolist()
    [0.0, 1.0]
    """
    if len(patterns) == 0:
        return np.zeros((0,), dtype=np.float64)
    bits_list = [
        normalize_bitstring(p, circuit.num_qubits()) for p in patterns
    ]
    mask = wildcard_mask(bits_list[0])
    for bits in bits_list[1:]:
        if wildcard_mask(bits) != mask:
            raise ValueError(
                "all patterns of a marginal sweep must share one "
                f"wildcard mask (got {wildcard_mask(bits)!r} and "
                f"{mask!r}); split per-mask or pad with bits"
            )
    bound = bind_marginal(
        circuit, mask, pathfinder, plan_cache, target_size
    )
    return marginal_probabilities(bound, bits_list, backend)
