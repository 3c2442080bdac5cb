"""Execution backends for compiled contraction programs (the port's
counterpart of ``tnc_tpu.ops.backends``):

- :class:`NumpyBackend` — the host oracle, complex128 numpy.
- :class:`TorchBackend` — PyTorch on the GPU (or, when asked, the CPU):
  the steps run eagerly, each buffer freed as soon as its step consumed
  it. On the GPU the default is split-complex mode — every tensor a
  (real, imag) float32 pair, steps planned by the kernel ladder of
  :mod:`tnc_tpu_torch.ops.split_complex` (chains of small steps through
  the hand-written ``fused_chain`` kernel, the stem step through Strassen,
  the rest through the Gauss identity).
"""

from __future__ import annotations

import logging
from typing import Any, Sequence

import numpy as np

from tnc_tpu_torch.ops.program import ContractionProgram

logger = logging.getLogger(__name__)


class Backend:
    name: str = "base"

    def execute(self, program: ContractionProgram, arrays: Sequence[Any]) -> np.ndarray:
        raise NotImplementedError


def apply_step(a: Any, b: Any, step) -> Any:
    """One pairwise contraction of native (complex) arrays — numpy arrays
    or torch tensors alike: prep each operand (view + macro permute +
    reshape), fold it to a ``(k, free)`` matrix, one matmul."""
    av = a.reshape(step.a_view)
    if step.a_perm is not None:
        av = av.transpose(step.a_perm) if isinstance(av, np.ndarray) else av.permute(step.a_perm)
    bv = b.reshape(step.b_view)
    if step.b_perm is not None:
        bv = bv.transpose(step.b_perm) if isinstance(bv, np.ndarray) else bv.permute(step.b_perm)
    av = av.reshape(step.a_dot)
    bv = bv.reshape(step.b_dot)
    a2 = av.reshape(step.a_mat) if step.a_cfirst else av.reshape(step.a_mat[::-1]).T
    b2 = bv.reshape(step.b_mat) if step.b_cfirst else bv.reshape(step.b_mat[::-1]).T
    out = (b2.T @ a2) if step.swap else (a2.T @ b2)
    return out.reshape(step.out_store)


def _run_steps(program: ContractionProgram, buffers: list[Any]) -> Any:
    """Execute all steps; returns the result in **stored** shape."""
    for step in program.steps:
        buffers[step.lhs] = apply_step(buffers[step.lhs], buffers[step.rhs], step)
        buffers[step.rhs] = None  # free eagerly
    return buffers[program.result_slot]


def place_buffers(
    arrays: Sequence[Any],
    dtype,
    split_complex: bool,
    device,
) -> list[Any]:
    """Host arrays → device tensors: complex tensors as-is, or (real,
    imag) float pairs in split mode (float64 parts for complex128)."""
    import torch

    complex_dtype = _complex_dtype(dtype)
    if split_complex:
        part = torch.float64 if complex_dtype == torch.complex128 else torch.float32
        out = []
        for a in arrays:
            a = np.asarray(a)
            out.append((
                torch.from_numpy(np.ascontiguousarray(a.real)).to(device=device, dtype=part),
                torch.from_numpy(np.ascontiguousarray(a.imag)).to(device=device, dtype=part),
            ))
        return out
    return [
        torch.from_numpy(np.asarray(a)).to(device=device, dtype=complex_dtype)
        for a in arrays
    ]


def _complex_dtype(dtype):
    import torch

    if dtype in ("complex128", np.complex128, torch.complex128):
        return torch.complex128
    if dtype in ("complex64", np.complex64, torch.complex64):
        return torch.complex64
    raise ValueError(f"unsupported dtype {dtype!r}: complex64 or complex128")


class NumpyBackend(Backend):
    """The host oracle: every step a complex128 numpy matmul."""

    name = "numpy"

    def execute(self, program: ContractionProgram, arrays: Sequence[Any]) -> np.ndarray:
        buffers = [np.asarray(a, dtype=np.complex128) for a in arrays]
        out = _run_steps(program, buffers)
        return np.asarray(out).reshape(program.result_shape)


#: precision names the backend accepts. ``float32`` is the reference's
#: HIGHEST; ``high`` and ``default`` also run full FP32 in this port
#: (never TF32 — 3xTF32 for ``high`` is later work).
PRECISIONS = (None, "default", "high", "float32", "highest")


class TorchBackend(Backend):
    """Eager whole-program execution with PyTorch.

    ``device=None`` means ``"cuda"``; if CUDA is absent the constructor
    raises — it never falls back to the CPU. Pass ``device="cpu"`` to run
    on the host (the tests do). ``split_complex=None`` means split on
    CUDA and native complex on the CPU. On CUDA the constructor turns
    TF32 off for matmuls and cuDNN
    (``torch.backends.cuda.matmul.allow_tf32 = False``,
    ``torch.backends.cudnn.allow_tf32 = False``): every ``precision`` runs
    true FP32, the hand kernels FP32 FMA.

    >>> from tnc_tpu_torch.tensornetwork.tensor import CompositeTensor, LeafTensor
    >>> from tnc_tpu_torch.tensornetwork.tensordata import TensorData
    >>> from tnc_tpu_torch.contractionpath.paths import Greedy, OptMethod
    >>> from tnc_tpu_torch.ops.program import build_program, flat_leaf_tensors
    >>> tn = CompositeTensor([
    ...     LeafTensor([0], [2], TensorData.matrix(np.array([1.0, 2.0]))),
    ...     LeafTensor([0], [2], TensorData.matrix(np.array([3.0, 4.0])))])
    >>> program = build_program(tn, Greedy(OptMethod.GREEDY).find_path(tn).replace_path())
    >>> arrays = [l.data.into_data() for l in flat_leaf_tensors(tn)]
    >>> complex(TorchBackend(device="cpu", split_complex=True).execute(program, arrays))
    (11+0j)
    """

    name = "torch"

    def __init__(
        self,
        dtype="complex64",
        device=None,
        split_complex: bool | None = None,
        precision: str | None = "float32",
    ):
        import torch

        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "TorchBackend: CUDA is not available; pass device='cpu' "
                    "to run on the host"
                )
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        if precision not in PRECISIONS:
            raise ValueError(f"unknown precision {precision!r}: one of {PRECISIONS}")
        self.dtype = dtype
        _complex_dtype(dtype)  # validate
        if split_complex is None:
            split_complex = self.device.type != "cpu"
        self.split_complex = split_complex
        self.precision = precision
        self._policy_cache: dict[tuple, Any] = {}

    def kernel_policy(self, program: ContractionProgram):
        """The kernel promotion ladder for ``program`` (split mode only;
        ``None`` otherwise), planned once per (program, env override) and
        cached."""
        if not self.split_complex:
            return None
        from tnc_tpu_torch.ops.split_complex import (
            complex_mult_key,
            dot_precision_key,
            plan_kernels,
        )

        key = (program.signature(), complex_mult_key(), dot_precision_key())
        policy = self._policy_cache.get(key)
        if policy is None:
            policy = plan_kernels(program)
            self._policy_cache[key] = policy
        return policy

    def _device_buffers(self, arrays: Sequence[Any]) -> list[Any]:
        return place_buffers(arrays, self.dtype, self.split_complex, self.device)

    def _run(self, program: ContractionProgram, buffers: list[Any]):
        import torch

        with torch.inference_mode():
            if self.split_complex:
                from tnc_tpu_torch.ops.split_complex import run_steps_split

                return run_steps_split(
                    program, buffers, self.precision,
                    policy=self.kernel_policy(program),
                )
            return _run_steps(program, buffers)

    def execute(self, program: ContractionProgram, arrays: Sequence[Any]) -> np.ndarray:
        result = self.execute_on_device(program, arrays)
        if self.split_complex:
            from tnc_tpu_torch.ops.split_complex import combine_array

            return combine_array(*result).reshape(program.result_shape)
        return result.cpu().numpy().reshape(program.result_shape)

    def execute_on_device(self, program: ContractionProgram, arrays: Sequence[Any]):
        """Like :meth:`execute` but leaves the result on the device (a
        (real, imag) pair in split mode), in **stored** shape
        (``program.stored_result_shape``) with axes in
        ``program.result_legs`` order."""
        buffers = self._device_buffers(arrays)
        return self._run(program, buffers)

    def bind_resident(self, program: ContractionProgram, arrays: Sequence[Any]):
        """Place ``arrays`` on the device once and return a callable that
        runs the program on those resident inputs and returns the
        device-resident result (stored shape). The inputs are never
        consumed, so the callable can be called any number of times."""
        buffers = self._device_buffers(arrays)
        return lambda: self._run(program, list(buffers))


_BACKENDS: dict[str, Backend] = {}


def get_backend(name: str | Backend | None = None) -> Backend:
    """Resolve a backend by name (``numpy``, ``torch``), instance, or
    default (``None``: ``torch``, i.e. :class:`TorchBackend` on the GPU,
    which raises without CUDA). The complex128 host oracle runs only when
    asked for by name or instance."""
    if isinstance(name, Backend):
        return name
    if name is None:
        name = "torch"
    backend = _BACKENDS.get(name)
    if backend is None:
        if name == "numpy":
            backend = NumpyBackend()
        elif name == "torch":
            backend = TorchBackend()
        else:
            raise ValueError(f"Unknown backend '{name}'")
        _BACKENDS[name] = backend
    return backend
