"""Batched amplitude sweeps: many bitstrings through one program (the
port's counterpart of ``tnc_tpu.tensornetwork.sweep``).

An amplitude network's *structure* does not depend on the bitstring —
only the ⟨0|/⟨1| bra leaf values change — so one contraction path, one
compiled program and one batched run over the stacked bra values
evaluate B amplitudes at once
(:meth:`~tnc_tpu_torch.ops.backends.TorchBackend.execute_batched`).

:func:`amplitude_sweep_value_and_grad` differentiates a real scalar of
the batch's amplitudes with respect to the shared leaves, through
``torch.autograd`` on the same batched program.

The sweep plans on the **raw** (unsimplified) network: host
simplification folds bra values into neighbouring cores, which would
make the shared leaf arrays bitstring-dependent. Rank-≤2 absorption
happens inside the planned path instead, so every non-bra leaf stays
bitstring-independent.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from tnc_tpu_torch.builders.circuit_builder import BASIS_STATES, Circuit
from tnc_tpu_torch.contractionpath.paths.base import Pathfinder
from tnc_tpu_torch.ops.program import build_program, flat_leaf_tensors


def _sweep_program(circuit, bitstrings, pathfinder):
    """Shared sweep prologue: validate bitstrings, build the amplitude
    network, plan, compile, and stack per-bitstring bra values.

    Returns ``(program, arrays, bra_slots)``; ``arrays[slot]`` for bra
    slots carries the stacked ``(B, 2)`` sweep axis. The finalizer
    pushes one bra per qubit, in qubit order, after every circuit
    tensor — they are the trailing ``n`` leaves.
    """
    n = len(bitstrings[0])
    for b in bitstrings:
        if len(b) != n:
            raise ValueError("all bitstrings must have equal length")
        if any(c not in "01" for c in b):
            raise ValueError(
                "the amplitude branch of a sweep requires fully "
                "determined bitstrings ('*' wildcards route to the "
                "marginal branch before this point)"
            )

    tn, _ = circuit.into_amplitude_network(bitstrings[0])
    leaves = flat_leaf_tensors(tn)
    bra_slots = list(range(len(leaves) - n, len(leaves)))

    if pathfinder is None:
        from tnc_tpu_torch.contractionpath.paths import Greedy, OptMethod

        pathfinder = Greedy(OptMethod.GREEDY)
    result = pathfinder.find_path(tn)
    program = build_program(tn, result.replace_path())

    arrays = [leaf.data.into_data() for leaf in leaves]
    for qubit, slot in enumerate(bra_slots):
        arrays[slot] = np.stack([BASIS_STATES[b[qubit]] for b in bitstrings])
    return program, arrays, bra_slots


def amplitude_sweep(
    circuit: Circuit,
    bitstrings: Sequence[str],
    pathfinder: Pathfinder | None = None,
    backend=None,
) -> np.ndarray:
    """Amplitudes ⟨b|C|0…0⟩ for every bitstring ``b``, sharing one path
    and one program. Returns a complex ``(len(bitstrings),)`` array in
    input order.

    ``circuit`` is consumed (finalizer semantics). All bitstrings must be
    of equal length. ``backend=None`` is :class:`~tnc_tpu_torch.ops.
    backends.TorchBackend` on the card, which raises without CUDA; pass
    ``TorchBackend(device="cpu")`` or ``NumpyBackend()`` for the host.

    **Wildcards**: a ``'*'`` position marginalizes that qubit — the
    sweep returns the real marginal *probabilities* of the determined
    positions (``Σ_wildcards |⟨b|C|0⟩|²``), contracted as traced
    sandwich legs by :func:`tnc_tpu_torch.queries.marginal.
    marginal_sweep`. All bitstrings of one sweep must then share the
    same wildcard mask.

    >>> from tnc_tpu_torch.ops.backends import NumpyBackend
    >>> from tnc_tpu_torch.tensornetwork.tensordata import TensorData
    >>> c = Circuit(); reg = c.allocate_register(2)
    >>> c.append_gate(TensorData.gate("x"), [reg.qubit(0)])
    >>> amplitude_sweep(c, ["1*", "0*"], backend=NumpyBackend()).tolist()
    [1.0, 0.0]

    >>> import math
    >>> c = Circuit(); reg = c.allocate_register(3)
    >>> c.append_gate(TensorData.gate("h"), [reg.qubit(0)])
    >>> for i in range(2):
    ...     c.append_gate(TensorData.gate("cx"), [reg.qubit(i), reg.qubit(i + 1)])
    >>> amps = amplitude_sweep(c, ["000", "111", "010"], backend=NumpyBackend())
    >>> [round(abs(a), 6) for a in amps] == [
    ...     round(1 / math.sqrt(2), 6), round(1 / math.sqrt(2), 6), 0.0]
    True
    """
    if not bitstrings:
        return np.zeros((0,), dtype=np.complex128)
    if any("*" in str(b) for b in bitstrings):
        # wildcard sweep = marginal probabilities over the sandwich network
        from tnc_tpu_torch.queries.marginal import marginal_sweep

        return marginal_sweep(
            circuit, list(bitstrings), pathfinder=pathfinder,
            backend=backend,
        )
    program, arrays, bra_slots = _sweep_program(
        circuit, bitstrings, pathfinder
    )

    if backend is None:
        from tnc_tpu_torch.ops.backends import TorchBackend

        backend = TorchBackend()
    if hasattr(backend, "execute_batched"):
        out = backend.execute_batched(program, arrays, bra_slots)
        return np.asarray(out).reshape(len(bitstrings))

    # a generic backend: one run per bitstring (same result)
    out = np.zeros((len(bitstrings),), dtype=np.complex128)
    bra_set = set(bra_slots)
    for i in range(len(bitstrings)):
        per = [
            a[i] if slot in bra_set else a for slot, a in enumerate(arrays)
        ]
        out[i] = complex(np.asarray(backend.execute(program, per)).reshape(-1)[0])
    return out


def total_probability(amps):
    """The default ``scalar_fn`` of :func:`amplitude_sweep_value_and_grad`:
    the batch's probability mass ``Σ_b |amp_b|²``."""
    import torch

    return torch.sum(amps.real ** 2 + amps.imag ** 2)


def amplitude_sweep_value_and_grad(
    circuit: Circuit,
    bitstrings: Sequence[str],
    wrt: Sequence[int] | None = None,
    scalar_fn=None,
    pathfinder: Pathfinder | None = None,
    dtype: str = "complex64",
    device=None,
):
    """Amplitudes for every bitstring AND the gradient of a real scalar
    of them w.r.t. selected (non-bra) leaf tensors — one reverse-mode
    sweep through ``torch.autograd`` over the same batched program the
    forward sweep runs (the bras a leading batch axis,
    :func:`~tnc_tpu_torch.ops.batched.run_steps_batched`). The default
    ``scalar_fn`` is the total probability mass ``Σ_b |amp_b|²`` of the
    batch (:func:`total_probability`); a caller's maps the complex
    ``(B,)`` amplitude tensor to a real scalar tensor.

    ``wrt`` indexes the flat leaf order (``flat_leaf_tensors``; bra
    slots — the trailing ``n`` leaves — are the sweep axis and cannot be
    differentiated here). Returns ``(amps, grads)``; cotangents follow
    the ``df = Re(sum(g * dT))`` convention of
    :mod:`tnc_tpu_torch.ops.autodiff`. ``device=None`` means ``"cuda"``
    (raises without CUDA, TF32 off).
    """
    import torch

    from tnc_tpu_torch.ops.autodiff import (
        _validate_wrt,
        cotangents,
        grad_of,
        leaf_tensors,
    )
    from tnc_tpu_torch.ops.backends import resolve_device
    from tnc_tpu_torch.ops.batched import run_steps_batched, thread_batch

    if not bitstrings:
        raise ValueError("amplitude_sweep_value_and_grad needs >= 1 bitstring")
    device = resolve_device(device, "amplitude_sweep_value_and_grad")
    program, host_arrays, bra_slots = _sweep_program(
        circuit, bitstrings, pathfinder
    )
    bra_set = set(bra_slots)
    n_slots = len(host_arrays)
    if wrt is None:
        wrt = [s for s in range(n_slots) if s not in bra_set]
    wrt = _validate_wrt(wrt, n_slots)
    for s in wrt:
        if s in bra_set:
            raise ValueError(
                "bra slots carry the sweep axis; not differentiable"
            )
    scalar_fn = scalar_fn or total_probability
    arrays = leaf_tensors(host_arrays, wrt, dtype, device)
    flags, _ = thread_batch(program, bra_slots)
    with torch.enable_grad():
        amps = run_steps_batched(program, list(arrays), flags).reshape(len(bitstrings))
        grads = grad_of(scalar_fn(amps), [arrays[s] for s in wrt])
    return amps.detach().cpu().numpy(), cotangents(grads)
