"""Differentiable contraction through ``torch.autograd`` (the port's
counterpart of ``tnc_tpu.ops.autodiff``).

Every step the native complex runner executes
(:func:`~tnc_tpu_torch.ops.backends._run_steps`: views, permutes and one
complex matmul a step) is differentiable, so autograd differentiates a
whole contraction. The natural applications are variational quantum
circuits: the gradient of an expectation value ⟨ψ(θ)|O|ψ(θ)⟩ (or of a
single amplitude) with respect to selected leaf tensors — e.g.
parameterized gate matrices — comes from one reverse-mode sweep over the
same program instead of parameter-shift re-contractions.

The gradient runs the complex runner, not the split-complex kernel policy:
the reference differentiates its plain complex path too, and none of the
hand kernels has a backward.

**Cotangent convention.** The returned cotangent ``g`` of leaf ``T``
follows the reference (JAX's reverse mode for real-valued ``f``):
``df = Re(sum(g * dT))`` for a perturbation ``dT``. PyTorch's ``.grad`` of
a real loss is the complex conjugate of that, so every entry point returns
``conj(.grad)``. ``scalar_fn`` maps the complex result tensor to a real
scalar tensor and defaults to the real part of its first element.

**Device.** ``device=None`` means ``"cuda"``: the entry points raise
without CUDA and turn TF32 off, as :class:`~tnc_tpu_torch.ops.backends.
TorchBackend` does (:func:`~tnc_tpu_torch.ops.backends.resolve_device`);
pass ``device="cpu"`` to run on the host.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

from tnc_tpu_torch.contractionpath.contraction_path import ContractionPath
from tnc_tpu_torch.ops.backends import _run_steps, place_buffers, resolve_device
from tnc_tpu_torch.ops.program import build_program, flat_leaf_tensors
from tnc_tpu_torch.tensornetwork.tensor import CompositeTensor


def _validate_wrt(wrt, n_slots: int) -> list[int]:
    """Flat-slot list for differentiation: in range (no negative
    indexing — slots are flat leaf indices) and duplicate-free (a
    duplicate would shadow the previous leaf and silently yield a
    zero gradient for every occurrence but the last).

    >>> _validate_wrt([2, 0], 3)
    [2, 0]
    >>> _validate_wrt([0, 0], 3)
    Traceback (most recent call last):
        ...
    ValueError: duplicate slots in wrt
    """
    wrt = list(wrt)
    if len(set(wrt)) != len(wrt):
        raise ValueError("duplicate slots in wrt")
    for s in wrt:
        if not 0 <= s < n_slots:
            raise ValueError(f"wrt slot {s} out of range 0..{n_slots - 1}")
    return wrt


def first_real(result):
    """The default ``scalar_fn``: the real part of the result's first
    element (an amplitude or expectation network contracts to a scalar)."""
    return result.reshape(-1)[0].real


def leaf_tensors(host_arrays, wrt: Sequence[int], dtype, device) -> list:
    """Host leaf arrays → complex tensors on ``device``; each slot in
    ``wrt`` a fresh leaf tensor with ``requires_grad`` (fresh, so that two
    slots never share one tensor and its gradient)."""
    arrays = place_buffers(host_arrays, dtype, False, device)
    for s in wrt:
        arrays[s] = arrays[s].detach().clone().requires_grad_(True)
    return arrays


def grad_of(value, inputs: Sequence, grad_outputs=None) -> list:
    """``torch.autograd.grad`` of ``value`` with respect to ``inputs``, an
    input that does not reach ``value`` getting zeros (JAX's answer)."""
    import torch

    return list(torch.autograd.grad(
        value, list(inputs), grad_outputs=grad_outputs, allow_unused=True,
        materialize_grads=True,
    ))


def cotangents(grads) -> list[np.ndarray]:
    """PyTorch gradients → the reference's cotangents on the host:
    ``conj(.grad)``, so that ``df = Re(sum(g * dT))``."""
    return [g.detach().conj().resolve_conj().cpu().numpy() for g in grads]


def _canonical(program):
    perm = program.canonical_perm()
    dim_of = dict(zip(program.result_legs, program.result_shape))
    return perm, tuple(dim_of[leg] for leg in program.canonical_legs)


def contraction_value_and_grad(
    tn: CompositeTensor,
    contract_path: ContractionPath,
    wrt: Sequence[int] | None = None,
    scalar_fn: Callable | None = None,
    dtype: str = "complex64",
    device=None,
):
    """Value and gradient of a contraction w.r.t. selected leaf tensors.

    ``wrt``: flat leaf-slot indices (see `flat_leaf_tensors` order);
    default: all leaves. ``scalar_fn``: maps the (complex) result tensor
    to a real scalar tensor; default takes the real part of the first
    element.

    Returns ``(value, grads)`` where ``value`` is the full complex
    result (host array, canonical shape) and ``grads[i]`` is the
    cotangent for ``wrt[i]``, shaped like that leaf, in the reference's
    convention ``df = Re(sum(g * dT))`` (``conj`` of PyTorch's
    ``.grad``).

    >>> from tnc_tpu_torch.builders.circuit_builder import Circuit
    >>> from tnc_tpu_torch.tensornetwork.tensordata import TensorData
    >>> from tnc_tpu_torch.contractionpath.paths import Greedy, OptMethod
    >>> c = Circuit(); reg = c.allocate_register(3)
    >>> c.append_gate(TensorData.gate("h"), [reg.qubit(0)])
    >>> for i in range(2):
    ...     c.append_gate(TensorData.gate("cx"), [reg.qubit(i), reg.qubit(i + 1)])
    >>> tn, _ = c.into_amplitude_network("111")
    >>> path = Greedy(OptMethod.GREEDY).find_path(tn).replace_path()
    >>> value, grads = contraction_value_and_grad(tn, path, wrt=[0], device="cpu")
    >>> abs(complex(value.reshape(-1)[0]) - 2 ** -0.5) < 1e-6
    True
    >>> grads[0].shape   # cotangent shaped like leaf 0
    (2,)
    """
    import torch

    device = resolve_device(device, "contraction_value_and_grad")
    program = build_program(tn, contract_path)
    host = [leaf.data.into_data() for leaf in flat_leaf_tensors(tn)]
    wrt = _validate_wrt(range(len(host)) if wrt is None else wrt, len(host))
    scalar_fn = scalar_fn or first_real
    arrays = leaf_tensors(host, wrt, dtype, device)
    perm, canonical_shape = _canonical(program)
    with torch.enable_grad():
        out = _run_steps(program, list(arrays)).reshape(program.result_shape)
        if perm is not None:
            out = out.permute(perm)
        grads = grad_of(scalar_fn(out), [arrays[s] for s in wrt])
    return out.detach().cpu().numpy().reshape(canonical_shape), cotangents(grads)


def sliced_contraction_value_and_grad(
    tn: CompositeTensor,
    contract_path: ContractionPath,
    slicing,
    wrt: Sequence[int] | None = None,
    scalar_fn: Callable | None = None,
    dtype: str = "complex64",
    device=None,
):
    """Like :func:`contraction_value_and_grad` for a *sliced* plan: the
    value is the sum over all slice programs, and the gradient the sum of
    per-slice vector-Jacobian products, so memory stays at the sliced peak
    instead of the unsliced program's.

    Two passes over the slices, one slice's graph alive at a time (the
    reference gets the same bound from ``jax.checkpoint`` inside its
    ``fori_loop``):

    1. every slice runs without grad; the contributions accumulate with
       Kahan compensation (:func:`~tnc_tpu_torch.ops.sliced.kahan_add`),
       as the forward executors sum them;
    2. ``g_out = d scalar_fn(acc + comp) / d out`` by one
       ``torch.autograd.grad``; then each slice runs again with grad on
       and ``g_out`` is back-propagated through it alone. The Kahan sum's
       vector-Jacobian product is the identity per slice, so the per-slice
       gradients add up to the reference's cotangent.

    Returns ``(value, grads)`` as :func:`contraction_value_and_grad` does.
    """
    import torch

    from tnc_tpu_torch.ops.sliced import (
        _slice_indices,
        build_sliced_program,
        index_buffer,
        kahan_add,
    )

    device = resolve_device(device, "sliced_contraction_value_and_grad")
    sp = build_sliced_program(tn, contract_path, slicing)
    host = [leaf.data.into_data() for leaf in flat_leaf_tensors(tn)]
    wrt = _validate_wrt(range(len(host)) if wrt is None else wrt, len(host))
    scalar_fn = scalar_fn or first_real
    arrays = leaf_tensors(host, wrt, dtype, device)
    diff = [arrays[s] for s in wrt]
    program = sp.program
    perm, canonical_shape = _canonical(program)

    def contribution(s: int):
        indices = _slice_indices(sp.slicing, s)
        return _run_steps(program, [index_buffer(arr, info, indices)
                                    for arr, info in zip(arrays, sp.slot_slices)])

    with torch.no_grad():
        acc = torch.zeros(program.stored_result_shape, dtype=arrays[0].dtype, device=device)
        comp = torch.zeros_like(acc)
        for s in range(sp.slicing.num_slices):
            acc, comp = kahan_add(acc, comp, contribution(s))
        total = acc + comp
    with torch.enable_grad():
        stored = total.detach().requires_grad_(True)
        out = stored.reshape(program.result_shape)
        if perm is not None:
            out = out.permute(perm)
        (g_out,) = grad_of(scalar_fn(out), [stored])
    grads = [torch.zeros_like(x) for x in diff]
    for s in range(sp.slicing.num_slices):
        with torch.enable_grad():
            parts = grad_of(contribution(s), diff, grad_outputs=g_out)
        for g, part in zip(grads, parts):
            g += part
    return out.detach().cpu().numpy().reshape(canonical_shape), cotangents(grads)
