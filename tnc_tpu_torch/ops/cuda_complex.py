"""Hand-written CUDA kernels for split-complex products, with their wrappers
and plain PyTorch versions — the port's counterpart of
``tnc_tpu.ops.pallas_complex``.

Two kernels, built from ``csrc/`` for Hopper (``sm_90a``) with ``nvcc`` at
first use and loaded through ``ctypes``:

- :func:`fused_complex_dot` (``csrc/fused_complex_dot.cu``) computes
  ``re = arᵀbr − aiᵀbi`` and ``im = arᵀbi + aiᵀbr`` for contract-first
  ``A: (K, M)``, ``B: (K, N)`` in one pass — the counterpart of
  ``fused_complex_dot_kl``;
- :func:`fused_chain` (``csrc/fused_chain.cu``) runs a whole chain of
  small consecutive steps (grouped by
  :func:`tnc_tpu_torch.ops.program.chain_groups`) as one cooperative launch
  — the counterpart of ``fused_chain_kl``.

Beside each kernel is its plain version (:func:`fused_complex_dot_reference`,
:func:`fused_chain_reference`). A wrapper given CPU tensors runs the plain
version: that is the CPU implementation. Given CUDA tensors it launches the
kernel or raises; nothing here falls back from the kernel to the plain
version. :data:`LAUNCHES` counts the kernel launches per kernel (plain
versions are not counted), so a run can show it went through the kernels.

The arithmetic is FP32 (or FP64) FMA on the CUDA cores; TF32 is never used.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

MIN_FLOPS = 1 << 22  # below this a single step is launch-dominated

#: budget of a fused chain, in float32 elements summed over every operand
#: and intermediate the chain touches ((real, imag) pairs count double).
#: Kept at the reference's value so :func:`~tnc_tpu_torch.ops.program.
#: chain_groups` forms the same chains as the JAX package; the kernel keeps
#: its carried value in global scratch (resident in L2), so the bound is
#: not a shared-memory limit here.
CHAIN_MAX_ELEMS = 1 << 20

#: kernel launches per kernel since the last :func:`reset_launches`
LAUNCHES: dict[str, int] = {"fused_chain": 0, "fused_complex_dot": 0}

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
_SOURCES = {
    "fused_complex_dot": "fused_complex_dot.cu",
    "fused_chain": "fused_chain.cu",
}
_HEADERS = ("complex_tile.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

#: ``ptxas -v`` output (registers, shared memory, spills) of each kernel
#: built by this process, by kernel name
BUILD_LOG: dict[str, str] = {}

_LIBS: dict[str, ctypes.CDLL] = {}
_LIB_LOCK = threading.Lock()
_CHAIN_PLANS: dict[tuple, "_ChainPlan"] = {}
_CHAIN_PLANS_MAX = 4096  # distinct chain shapes kept before the cache restarts


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def ineligible_reason(k: int, m: int, n: int) -> str | None:
    """Why the single-step fused kernel should not take a (K,M)x(K,N)
    problem — ``None`` when it should. The port's gate keeps the
    reference's ``flop_floor``; the reference's ``tile_floor`` does not
    apply, because the CUDA kernel bounds-checks ragged edges and takes any
    shape. (The ``layout`` reason — both operands contract-first — is
    checked by the caller, which sees the step.)

    >>> ineligible_reason(512, 1024, 1024) is None
    True
    >>> ineligible_reason(4, 4, 4)
    'flop_floor'
    >>> ineligible_reason(1024, 4, 1024) is None   # no tile floor here
    True
    """
    if 2 * k * m * n < MIN_FLOPS:
        return "flop_floor"
    return None


def eligible(k: int, m: int, n: int) -> bool:
    """Should the fused kernel take this (K,M)x(K,N) problem?"""
    return ineligible_reason(k, m, n) is None


# -- building and loading -------------------------------------------------


def build_dir() -> Path:
    """Where the kernels' shared libraries are built:
    ``TNC_TPU_TORCH_KERNEL_DIR`` if set, else ``_build/`` beside this
    module (listed in ``.gitignore``)."""
    env = os.environ.get("TNC_TPU_TORCH_KERNEL_DIR")
    return Path(env) if env else Path(__file__).resolve().parent / "_build"


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels are built "
            "from source at first use"
        )
    return found


def _source_digest(name: str) -> str:
    h = hashlib.sha256()
    for fname in (_SOURCES[name],) + _HEADERS:
        h.update((CSRC_DIR / fname).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    """The shared library of kernel ``name`` for the current sources."""
    return build_dir() / f"{name}-{_source_digest(name)}.so"


def build_kernels(names=None) -> dict[str, Path]:
    """Build the kernels ``names`` (default: all) whose library for the
    current sources does not exist yet — one ``nvcc`` per source, all
    started together — and return each kernel's library path. Raises if
    a build fails."""
    names = list(_SOURCES) if names is None else list(names)
    out = {name: library_path(name) for name in names}
    todo = [name for name in names if not out[name].exists()]
    if not todo:
        return out
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        tmp = out[name].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / _SOURCES[name])]
        procs[name] = (
            tmp,
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ),
        )
    errors = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            errors.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out[name])
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return out


_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int


def _library(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LIB_LOCK:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        # the first kernel a process needs builds them all, in parallel
        path = build_kernels()[name]
        lib = ctypes.CDLL(str(path))
        lib.tnc_error_string.argtypes = [_I]
        lib.tnc_error_string.restype = ctypes.c_char_p
        if name == "fused_complex_dot":
            for fn in (lib.tnc_fused_complex_dot_f32, lib.tnc_fused_complex_dot_f64):
                fn.argtypes = [_P, _P, _LL, _LL, _P, _P, _LL, _LL, _P, _P,
                               _LL, _LL, _LL, _P]
                fn.restype = _I
        else:
            for fn in (lib.tnc_fused_chain_f32, lib.tnc_fused_chain_f64):
                fn.argtypes = [_P, _P, _I, _P, _LL, _P, _P, _P]
                fn.restype = _I
            lib.tnc_chain_max_stages.restype = _I
            lib.tnc_chain_table_fields.restype = _I
            if (lib.tnc_chain_table_fields(), lib.tnc_chain_max_stages()) != (
                _CHAIN_FIELDS, CHAIN_STAGES_PER_LAUNCH
            ):
                raise RuntimeError("fused_chain library and wrapper disagree")
        _LIBS[name] = lib
        return lib


def _check(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.tnc_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel failed: CUDA error {rc} ({msg})")


def _stream(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def _check_parts(what: str, tensors) -> None:
    """Device, dtype and rank checks shared by both wrappers."""
    import torch

    device, dtype = tensors[0].device, tensors[0].dtype
    for t in tensors:
        if t.device != device:
            raise ValueError(f"{what}: operands on different devices")
        if t.dtype != dtype:
            raise ValueError(f"{what}: operands of different dtypes")
        if t.dim() != 2:
            raise ValueError(f"{what}: operands must be 2-D, got {tuple(t.shape)}")
    if device.type == "cuda" and dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{what}: kernel takes float32 or float64, got {dtype}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: no implementation for device {device}")


def _check_pair(what: str, re, im) -> None:
    if re.shape != im.shape or re.stride() != im.stride():
        raise ValueError(
            f"{what}: real and imaginary parts differ in shape or strides"
        )


# -- single-step fused complex product -------------------------------------


def fused_complex_dot_reference(ar, ai, br, bi):
    """Plain version of :func:`fused_complex_dot`: the naive four
    ``torch.matmul`` lowering."""
    return ar.T @ br - ai.T @ bi, ar.T @ bi + ai.T @ br


def fused_complex_dot(ar, ai, br, bi):
    """``(re, im)`` of the complex product ``(ar+i·ai)ᵀ · (br+i·bi)``.

    ``ar, ai: (K, M)``; ``br, bi: (K, N)``, float32 or float64 (any
    strides, real and imaginary parts alike); outputs ``(M, N)`` of the
    same dtype. CPU tensors run :func:`fused_complex_dot_reference`; CUDA
    tensors launch the kernel on the current stream.
    """
    import torch

    _check_parts("fused_complex_dot", (ar, ai, br, bi))
    _check_pair("fused_complex_dot", ar, ai)
    _check_pair("fused_complex_dot", br, bi)
    k, m = ar.shape
    kb, n = br.shape
    if kb != k:
        raise ValueError(f"fused_complex_dot: contract dims differ ({k} vs {kb})")
    if ar.device.type == "cpu":
        return fused_complex_dot_reference(ar, ai, br, bi)
    lib = _library("fused_complex_dot")
    fn = (
        lib.tnc_fused_complex_dot_f32
        if ar.dtype == torch.float32
        else lib.tnc_fused_complex_dot_f64
    )
    re = torch.empty((m, n), dtype=ar.dtype, device=ar.device)
    im = torch.empty((m, n), dtype=ar.dtype, device=ar.device)
    with torch.cuda.device(ar.device):
        rc = fn(
            ar.data_ptr(), ai.data_ptr(), ar.stride(0), ar.stride(1),
            br.data_ptr(), bi.data_ptr(), br.stride(0), br.stride(1),
            re.data_ptr(), im.data_ptr(), k, m, n, _stream(ar.device),
        )
    _check(lib, rc, "fused_complex_dot")
    LAUNCHES["fused_complex_dot"] += 1
    return re, im


# -- fused multi-step chains ------------------------------------------------


class ChainLink:
    """Static metadata for one follow-on step of a fused chain: how the
    carried value (the previous step's output) enters this step's product
    against its prepped ``(K, X)`` operand.

    ``carried_shape``: the 2-D matrix the flat carried value regroups to
    (a pure row-major reshape — :func:`tnc_tpu_torch.ops.program.
    chain_groups` only admits steps whose carried operand needs no
    transpose). ``k_axis``: which axis of that matrix is the contract dim
    (0 = contract-first, 1 = contract-last). ``carried_first``: whether the
    carried value is the product's first operand (its free axis supplies
    the output rows) — the PairStep ``swap`` folded out.
    """

    __slots__ = ("carried_first", "carried_shape", "k_axis")

    def __init__(
        self,
        carried_first: bool,
        carried_shape: tuple[int, int],
        k_axis: int,
    ):
        self.carried_first = bool(carried_first)
        self.carried_shape = (int(carried_shape[0]), int(carried_shape[1]))
        self.k_axis = int(k_axis)

    def out_shape(self, link_free: int) -> tuple[int, int]:
        free = self.carried_shape[1 - self.k_axis]
        if self.carried_first:
            return (free, link_free)
        return (link_free, free)

    def key(self) -> tuple:
        return (self.carried_first, self.carried_shape, self.k_axis)


def chain_out_shape(
    m0: int, n0: int, links, link_frees
) -> tuple[int, int]:
    """Final 2-D output shape of a chain starting at ``(m0, n0)``."""
    shape = (m0, n0)
    for link, free in zip(links, link_frees):
        shape = link.out_shape(free)
    return shape


def _cdot(xr, xi, yr, yi, xk: int, yk: int):
    """Naive split-complex product contracting axis ``xk`` of ``x`` with
    axis ``yk`` of ``y``: output rows are ``x``'s free axis."""
    x2r, x2i = (xr, xi) if xk == 0 else (xr.T, xi.T)
    y2r, y2i = (yr, yi) if yk == 0 else (yr.T, yi.T)
    return fused_complex_dot_reference(x2r, x2i, y2r, y2i)


def _chain_compute(vals, links):
    """The chain's arithmetic on plain tensors, in the reference's order
    (``tnc_tpu.ops.pallas_complex._chain_compute``): accumulation in the
    operand dtype."""
    zr, zi = _cdot(vals[0], vals[1], vals[2], vals[3], 0, 0)
    for i, link in enumerate(links):
        cr = vals[4 + 2 * i]
        ci = vals[5 + 2 * i]
        zr = zr.reshape(link.carried_shape)
        zi = zi.reshape(link.carried_shape)
        if link.carried_first:
            zr, zi = _cdot(zr, zi, cr, ci, link.k_axis, 0)
        else:
            zr, zi = _cdot(cr, ci, zr, zi, 0, link.k_axis)
    return zr, zi


def fused_chain_reference(first_ops, link_ops, links):
    """Plain version of :func:`fused_chain`: the steps one after another
    as ``torch.matmul`` calls."""
    vals = list(first_ops)
    for cr, ci in link_ops:
        vals.extend((cr, ci))
    return _chain_compute(vals, links)


# fields of one stage in the table the chain kernel reads, and the stages
# one launch takes (kFields, kMaxStages in csrc/fused_chain.cu)
_CHAIN_FIELDS = 10
CHAIN_STAGES_PER_LAUNCH = 32
_SCRATCH0, _SCRATCH1, _FINAL = -1, -2, -3


class _ChainPlan:
    """The static stage table of one chain shape: built once, reused by
    every call with the same operand shapes, strides and links."""

    __slots__ = ("table", "n_stages", "scratch_elems", "out_shape")

    def __init__(self, first_ops, link_ops, links):
        import numpy as np

        fr, _, sr, _ = first_ops
        k0, m0 = fr.shape
        n0 = sr.shape[1]
        rows = []
        # head: operand pairs 0 (first) and 1 (second)
        shape = (m0, n0)
        scratch = m0 * n0
        dst = _SCRATCH0 if links else _FINAL
        rows.append([0, fr.stride(0), fr.stride(1),
                     1, sr.stride(0), sr.stride(1), k0, m0, n0, dst])
        for i, ((cr, _), link) in enumerate(zip(link_ops, links)):
            src = dst
            dst = (_SCRATCH1 if src == _SCRATCH0 else _SCRATCH0)
            if i == len(links) - 1:
                dst = _FINAL
            r, c = link.carried_shape
            if r * c != shape[0] * shape[1]:
                raise ValueError(
                    f"fused_chain: link {i} regroups {shape} to {(r, c)}"
                )
            # the carried value is row-major (r, c); as a (K, F) operand
            # it has strides (c, 1) when k is axis 0, (1, c) when axis 1
            k = link.carried_shape[link.k_axis]
            f = link.carried_shape[1 - link.k_axis]
            z_sk, z_sf = (c, 1) if link.k_axis == 0 else (1, c)
            kc, x = cr.shape
            if kc != k:
                raise ValueError(
                    f"fused_chain: link {i} contracts {k} against {kc}"
                )
            pair = 2 + i
            if link.carried_first:
                rows.append([src, z_sk, z_sf, pair, cr.stride(0), cr.stride(1),
                             k, f, x, dst])
            else:
                rows.append([pair, cr.stride(0), cr.stride(1), src, z_sk, z_sf,
                             k, x, f, dst])
            shape = link.out_shape(x)
            if dst != _FINAL:
                scratch = max(scratch, shape[0] * shape[1])
        self.table = np.ascontiguousarray(rows, dtype=np.int64)
        self.n_stages = len(rows)
        self.scratch_elems = scratch if links else 0
        self.out_shape = shape


def _chain_plan(first_ops, link_ops, links) -> _ChainPlan:
    key = (
        first_ops[0].dtype,
        tuple((tuple(t.shape), t.stride()) for t in first_ops),
        tuple((tuple(c[0].shape), c[0].stride()) for c in link_ops),
        tuple(link.key() for link in links),
    )
    plan = _CHAIN_PLANS.get(key)
    if plan is None:
        if len(_CHAIN_PLANS) >= _CHAIN_PLANS_MAX:
            _CHAIN_PLANS.clear()
        plan = _ChainPlan(first_ops, link_ops, links)
        _CHAIN_PLANS[key] = plan
    return plan


def fused_chain(first_ops, link_ops, links):
    """Execute a whole chain of steps as ONE kernel launch.

    ``first_ops = (fr, fi, sr, si)``: the head step's two operands,
    prepped to contract-dim-leading 2-D ``(K0, M0)`` / ``(K0, N0)``
    matrices, already in product order (``swap`` folded out by the
    caller). ``link_ops = [(cr, ci), ...]``: each follow-on step's
    non-carried operand as ``(K_i, X_i)``. ``links``: one
    :class:`ChainLink` per follow-on step. Any strides are taken (real
    and imaginary parts alike). Returns the chain's final ``(re, im)``
    2-D pair, of the operands' dtype.

    CPU tensors run :func:`fused_chain_reference`. CUDA tensors launch the
    cooperative chain kernel once (a chain of more than 32 stages takes
    one launch per 32 stages).
    """
    import torch

    if len(links) != len(link_ops):
        raise ValueError("links and link_ops must pair up")
    flat = list(first_ops) + [t for pair in link_ops for t in pair]
    _check_parts("fused_chain", flat)
    for j in range(0, len(flat), 2):
        _check_pair("fused_chain", flat[j], flat[j + 1])
    fr, _, sr, _ = first_ops
    if fr.shape[0] != sr.shape[0]:
        raise ValueError("fused_chain: head contract dims differ")
    plan = _chain_plan(first_ops, link_ops, links)
    if fr.device.type == "cpu":
        return fused_chain_reference(first_ops, link_ops, links)
    lib = _library("fused_chain")
    dtype, device = fr.dtype, fr.device
    fn = lib.tnc_fused_chain_f32 if dtype == torch.float32 else lib.tnc_fused_chain_f64
    out_r = torch.empty(plan.out_shape, dtype=dtype, device=device)
    out_i = torch.empty(plan.out_shape, dtype=dtype, device=device)
    scratch = torch.empty(
        (4 * max(plan.scratch_elems, 1),), dtype=dtype, device=device
    )
    ptrs = (ctypes.c_void_p * len(flat))(*[t.data_ptr() for t in flat])
    with torch.cuda.device(device):
        rc = fn(
            ptrs, plan.table.ctypes.data, plan.n_stages, scratch.data_ptr(),
            max(plan.scratch_elems, 1), out_r.data_ptr(), out_i.data_ptr(),
            _stream(device),
        )
    _check(lib, rc, "fused_chain")
    LAUNCHES["fused_chain"] += -(-plan.n_stages // CHAIN_STAGES_PER_LAUNCH)
    return out_r, out_i
