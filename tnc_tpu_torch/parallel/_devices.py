"""Devices, streams and transfers shared by the partition-parallel and the
slice-parallel executors (:mod:`~tnc_tpu_torch.parallel.partitioned`,
:mod:`~tnc_tpu_torch.parallel.sliced_parallel`).

A device buffer is a tensor, or in split mode a (real, imag) pair of
tensors; every helper here takes either.
"""

from __future__ import annotations

import contextlib
from typing import Any

import numpy as np


def process_index() -> int:
    """This process's rank in the process group (0 without one)."""
    from tnc_tpu_torch.obs.core import process_identity

    return process_identity()[1]


def group_up() -> bool:
    """Is a ``torch.distributed`` process group up in this process? (A
    group needs ``torch.distributed`` imported; a process that never
    imported it has none, and is not made to import it here.)"""
    import sys

    dist = sys.modules.get("torch.distributed")
    return dist is not None and dist.is_available() and dist.is_initialized()


def resolve_devices(devices=None, n_devices: int | None = None) -> list:
    """The ``torch.device`` list an executor runs on: ``devices`` as given
    (a device may repeat: ``[torch.device("cuda:0")] * 8`` runs an 8-way
    plan on one card), or, for ``None``, every visible CUDA device (the
    first ``n_devices``). A CUDA device raises without CUDA and turns TF32
    off (:func:`~tnc_tpu_torch.ops.backends.resolve_device`); too few
    devices for ``n_devices`` raises ``ValueError``."""
    import torch

    from tnc_tpu_torch.ops.backends import resolve_device

    if devices is None:
        resolve_device(None, "distributed executor")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devices = [resolve_device(d, "distributed executor") for d in devices]
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(f"need {n_devices} devices, have {len(devices)}")
        devices = devices[:n_devices]
    return devices


def device_slots(k: int) -> list:
    """``k`` device slots placed on the visible CUDA devices in turn: one
    card runs ``[cuda:0] * k``, two run ``[cuda:0, cuda:1, cuda:0, ...]``.
    Under the host pin (``TNC_TPU_PLATFORM=cpu``) every slot is the host;
    without the pin and without CUDA it raises, as
    :func:`~tnc_tpu_torch.ops.backends.resolve_device` does.

    >>> from tnc_tpu_torch.utils import logging_config
    >>> saved, logging_config._PINNED = logging_config._PINNED, "cpu"
    >>> device_slots(3)
    [device(type='cpu'), device(type='cpu'), device(type='cpu')]
    >>> logging_config._PINNED = saved
    """
    import torch

    from tnc_tpu_torch.ops.backends import resolve_device

    first = resolve_device(None, "device slots")
    if first.type != "cuda":
        return [first] * k
    n = torch.cuda.device_count()
    return [torch.device("cuda", i % n) for i in range(k)]


def rank_device(device=None):
    """This rank's device under a process group: ``device`` when given,
    else ``cuda:{LOCAL_RANK}`` (or ``cuda:{rank % device_count()}``),
    resolved by :func:`~tnc_tpu_torch.ops.backends.resolve_device` (which
    raises without CUDA)."""
    import os

    import torch

    from tnc_tpu_torch.ops.backends import resolve_device

    if device is None:
        if "LOCAL_RANK" in os.environ:
            index = int(os.environ["LOCAL_RANK"])
        else:
            index = process_index() % max(torch.cuda.device_count(), 1)
        device = f"cuda:{index}"
    return resolve_device(device, "distributed executor")


def make_backend(device, dtype: str, split_complex: bool, precision, **sliced):
    """A :class:`~tnc_tpu_torch.ops.backends.TorchBackend` on ``device``;
    ``sliced`` sets its sliced strategy and batching."""
    from tnc_tpu_torch.ops.backends import TorchBackend

    return TorchBackend(dtype=dtype, device=device, split_complex=split_complex,
                        precision=precision, **sliced)


def parts(buf) -> tuple:
    """The tensors of a device buffer: the pair itself, or a 1-tuple."""
    return buf if isinstance(buf, tuple) else (buf,)


def to_device(buf, device):
    """A device buffer on ``device``: an asynchronous copy between devices,
    the tensor itself on its own."""
    if isinstance(buf, tuple):
        return tuple(p.to(device, non_blocking=True) for p in buf)
    return buf.to(device, non_blocking=True)


def item_bytes(buf) -> int:
    """Bytes one element of a device buffer occupies (both parts of a
    split pair)."""
    return sum(p.element_size() for p in parts(buf))


@contextlib.contextmanager
def device_stream(device):
    """Run the body's CUDA work on a stream of its own on ``device`` (after
    the work already queued on the current stream), and make the current
    stream wait for it on exit: the order between a partition's local
    phase and the fan-in, kept by events. A no-op off CUDA."""
    if device.type != "cuda":
        yield
        return
    import torch

    current = torch.cuda.current_stream(device)
    stream = torch.cuda.Stream(device)
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        yield
    current.wait_stream(stream)


def handed_over(buf, device):
    """Mark the tensors of ``buf``, made on a side stream, as used by the
    current stream of ``device``, so the allocator does not hand their
    memory to the side stream's later work while the fan-in reads them."""
    if device.type == "cuda" and buf is not None:
        import torch

        for p in parts(buf):
            p.record_stream(torch.cuda.current_stream(device))
    return buf


def host_result(final: Any, split_complex: bool, shape) -> np.ndarray:
    """A device buffer as a complex host array of ``shape``."""
    if split_complex:
        from tnc_tpu_torch.ops.split_complex import combine_array

        data = combine_array(*final)
    else:
        data = final.cpu().numpy()
    return data.reshape(tuple(shape))
