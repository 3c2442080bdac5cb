"""Device-memory budget of sliced execution (the port's copy of
``tnc_tpu.ops.budget``).

The chunked executor runs a batch of slices at once, so every live
intermediate exists once per slice of the batch. This module models the
peak footprint of a compiled program step by step and clamps the
executor's ``slice_batch`` so the batch fits the card before anything is
launched — or reports, through :func:`fits_hbm`, that a deeper slicing is
needed.

Divergence from the reference: the reference pads every buffer's minor
dimension to the TPU's 128 lanes; a CUDA buffer is not tiled, so here an
element count is the plain product of the shape (as if the reference's
lane were 1).
"""

from __future__ import annotations

import logging
import math
import os
from dataclasses import dataclass

logger = logging.getLogger(__name__)

#: the reference's budget for a host (CPU) device
CPU_BYTES = 64 << 30


def device_hbm_bytes(device=None) -> int:
    """Memory of ``device`` (default: the current CUDA device) the budget
    is taken from: ``TNC_TPU_HBM_BYTES`` when set, else the card's total
    memory (``torch.cuda.mem_get_info``), or 64 GiB on a CPU device."""
    env = os.environ.get("TNC_TPU_HBM_BYTES")
    if env:
        return int(env)
    import torch

    device = torch.device("cuda" if device is None else device)
    if device.type == "cpu":
        return CPU_BYTES
    return int(torch.cuda.mem_get_info(device)[1])


def padded_elems(shape: tuple[int, ...]) -> int:
    """Element count of a buffer of ``shape`` (no tile padding on the GPU).

    >>> padded_elems((4, 128)), padded_elems((4, 2)), padded_elems(())
    (512, 8, 1)
    """
    return math.prod(shape) if shape else 1


@dataclass(frozen=True)
class PeakEstimate:
    peak_bytes: int  # modeled peak device memory of one slice-batch execution
    peak_step: int  # step index at the peak
    bytes_per_batch_unit: int  # marginal bytes per +1 slice in the batch


def program_peak_bytes(
    program,
    *,
    split_complex: bool = True,
    dtype_bytes: int = 4,
    batch: int = 1,
) -> PeakEstimate:
    """Model the peak device memory of executing ``program`` with a
    leading slice-batch of ``batch``.

    Per step the working set is: all live stored buffers, both post-perm
    operand materializations, the dot output, and (split mode) one extra
    output-sized Gauss temporary (k1 lives while k2/k3 are built). Leaves
    count as a floor of 8 elements each.
    """
    parts = 2 if split_complex else 1
    per_elem = dtype_bytes * parts

    live: dict[int, int] = {}
    for slot in range(program.num_inputs):
        live[slot] = 0  # leaf shapes are tiny; counted as free
    leaf_bytes = program.num_inputs * 8 * per_elem

    peak = leaf_bytes
    peak_step = -1
    for i, st in enumerate(program.steps):
        out = padded_elems(st.out_store)
        working = (
            sum(live.values())
            + padded_elems(tuple(st.a_dot))
            + padded_elems(tuple(st.b_dot))
            + out * (2 if split_complex else 1)  # dot out + gauss temp
        )
        cur = leaf_bytes + working * per_elem * batch
        if cur > peak:
            peak = cur
            peak_step = i
        live[st.lhs] = out
        live.pop(st.rhs, None)

    unit = (peak - leaf_bytes) // max(batch, 1)
    return PeakEstimate(int(peak), peak_step, int(unit))


def clamp_slice_batch(
    program,
    requested_batch: int,
    *,
    device=None,
    split_complex: bool = True,
    dtype_bytes: int = 4,
    safety: float = 0.75,
    hbm_bytes: int | None = None,
) -> int:
    """Largest batch ≤ ``requested_batch`` whose modeled peak fits in
    ``safety`` × the device's memory. Returns at least 1 (a batch of one
    either fits or the caller must slice deeper — see :func:`fits_hbm`)."""
    if hbm_bytes is None:
        hbm_bytes = device_hbm_bytes(device)
    budget = int(hbm_bytes * safety)
    est = program_peak_bytes(
        program, split_complex=split_complex, dtype_bytes=dtype_bytes, batch=1
    )
    if est.bytes_per_batch_unit <= 0:
        return max(1, requested_batch)
    fixed = est.peak_bytes - est.bytes_per_batch_unit  # leaf floor
    fit = max(1, (budget - fixed) // est.bytes_per_batch_unit)
    clamped = max(1, min(requested_batch, fit))
    if clamped < requested_batch:
        logger.info(
            "device memory budget: slice batch clamped %d -> %d "
            "(peak/unit %.2f GiB, budget %.2f GiB)",
            requested_batch,
            clamped,
            est.bytes_per_batch_unit / 2**30,
            budget / 2**30,
        )
    return clamped


def fits_hbm(
    program,
    *,
    batch: int = 1,
    device=None,
    split_complex: bool = True,
    dtype_bytes: int = 4,
    safety: float = 0.75,
    hbm_bytes: int | None = None,
) -> bool:
    """Does the modeled peak of one ``batch``-slice execution fit?"""
    if hbm_bytes is None:
        hbm_bytes = device_hbm_bytes(device)
    est = program_peak_bytes(
        program, split_complex=split_complex, dtype_bytes=dtype_bytes, batch=batch
    )
    return est.peak_bytes <= hbm_bytes * safety
