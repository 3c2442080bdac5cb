"""Hand-written CUDA kernels for split-complex products, with their wrappers
and plain PyTorch versions — the port's counterpart of
``tnc_tpu.ops.pallas_complex``.

Three kernels, built from ``csrc/`` for Hopper (``sm_90a``) with ``nvcc``
at first use and loaded through ``ctypes``:

- :func:`fused_complex_dot` (``csrc/fused_complex_dot.cu``) computes
  ``re = arᵀbr − aiᵀbi`` and ``im = arᵀbi + aiᵀbr`` for contract-first
  ``A: (K, M)``, ``B: (K, N)`` in one pass — the counterpart of
  ``fused_complex_dot_kl``;
- :func:`fused_transpose_dot` (``csrc/fused_transpose_dot.cu``) computes
  the same product with both operands read in their raw stored macro
  views, the permutation (an :class:`OperandLayout`) applied while tiles
  are fetched — the counterpart of ``fused_transpose_dot_kl``;
- :func:`fused_chain` (``csrc/fused_chain.cu``) runs a whole chain of
  small consecutive steps (grouped by
  :func:`tnc_tpu_torch.ops.program.chain_groups`) as one cooperative launch
  — the counterpart of ``fused_chain_kl``.

``fused_complex_dot`` and ``fused_chain`` also take a leading slice-batch
axis (``(B, K, X)`` operands beside 2-D ones, which every batch row
shares through a batch stride of 0): the chunked sliced executor's
batch, in one launch — the reference's ``vmap`` of its kernels.

The two single-product kernels share one pipelined tile engine
(``csrc/complex_gemm.cuh``: a ``cp.async`` ring, 128-bit fragment loads,
three real products per complex multiply-add); this module chooses its
launch configuration (:func:`gemm_config`) and each operand's copy mode
(:func:`strided_copy_mode`, :func:`gather_copy_mode`), so that choice is
tested on the CPU. The chain kernel keeps the small tile of
``csrc/complex_tile.cuh``.

Beside each kernel is its plain version (:func:`fused_complex_dot_reference`,
:func:`fused_transpose_reference`, :func:`fused_chain_reference`). A
wrapper given CPU tensors runs the plain
version: that is the CPU implementation. Given CUDA tensors it launches the
kernel or raises; nothing here falls back from the kernel to the plain
version. :data:`LAUNCHES` counts the kernel launches per kernel (plain
versions are not counted), so a run can show it went through the kernels.

The arithmetic is FP32 (or FP64) FMA on the CUDA cores; TF32 is never used.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import NamedTuple

MIN_FLOPS = 1 << 22  # below this a single step is launch-dominated

#: budget of a fused chain, in float32 elements summed over every operand
#: and intermediate the chain touches ((real, imag) pairs count double).
#: Kept at the reference's value so :func:`~tnc_tpu_torch.ops.program.
#: chain_groups` forms the same chains as the JAX package; the kernel keeps
#: its carried value in global scratch (resident in L2), so the bound is
#: not a shared-memory limit here.
CHAIN_MAX_ELEMS = 1 << 20

#: kernel launches per kernel since the last :func:`reset_launches`
LAUNCHES: dict[str, int] = {
    "fused_chain": 0, "fused_complex_dot": 0, "fused_transpose_dot": 0,
}

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
_SOURCES = {
    "fused_complex_dot": "fused_complex_dot.cu",
    "fused_chain": "fused_chain.cu",
    "fused_transpose_dot": "fused_transpose_dot.cu",
}
_HEADERS = ("complex_tile.cuh", "complex_gemm.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

#: ``ptxas -v`` output (registers, shared memory, spills) of each kernel's
#: library, by kernel name: from the build, or kept beside a library built
#: earlier
BUILD_LOG: dict[str, str] = {}

_LIBS: dict[str, ctypes.CDLL] = {}
_LIB_LOCK = threading.Lock()
_CHAIN_PLANS: dict[tuple, "_ChainPlan"] = {}
_CHAIN_PLANS_MAX = 4096  # distinct chain shapes kept before the cache restarts
# the transpose kernel's offset tables, by (digit sizes, strides, device)
_OFFSET_TABLES: dict[tuple, object] = {}
_OFFSET_TABLES_MAX = 256


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
    for name in names:
        log = out[name].with_suffix(".log")
        if name not in todo and log.exists():
            BUILD_LOG[name] = log.read_text()
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
        out[name].with_suffix(".log").write_text(log)
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
                fn.argtypes = [_P, _P, _LL, _LL, _LL, _I, _P, _P, _LL, _LL, _LL, _I,
                               _P, _P, _I, _LL, _LL, _LL, _I, _P]
                fn.restype = _I
        elif name == "fused_transpose_dot":
            for fn in (lib.tnc_fused_transpose_dot_f32,
                       lib.tnc_fused_transpose_dot_f64):
                fn.argtypes = [_P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _P, _P,
                               _LL, _LL, _LL, _I, _I, _P]
                fn.restype = _I
        else:
            for fn in (lib.tnc_fused_chain_f32, lib.tnc_fused_chain_f64):
                fn.argtypes = [_P, _P, _I, _I, _P, _LL, _P, _P, _P]
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


def _check_parts(what: str, tensors, two_d: bool = True) -> None:
    """Device and dtype checks shared by the wrappers (and, with
    ``two_d``, that every operand is a matrix, or a batch of matrices
    ``(B, rows, cols)``)."""
    import torch

    device, dtype = tensors[0].device, tensors[0].dtype
    for t in tensors:
        if t.device != device:
            raise ValueError(f"{what}: operands on different devices")
        if t.dtype != dtype:
            raise ValueError(f"{what}: operands of different dtypes")
        if two_d and t.dim() not in (2, 3):
            raise ValueError(
                f"{what}: operands must be 2-D or (batch, rows, cols), got "
                f"{tuple(t.shape)}")
    if device.type == "cuda" and dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{what}: kernel takes float32 or float64, got {dtype}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: no implementation for device {device}")


def _batch_of(what: str, tensors) -> int | None:
    """The slice batch of a kernel call: the leading size shared by its 3-D
    operands, or ``None`` when every operand is 2-D."""
    sizes = {int(t.shape[0]) for t in tensors if t.dim() == 3}
    if len(sizes) > 1:
        raise ValueError(f"{what}: operands disagree on the batch ({sorted(sizes)})")
    return sizes.pop() if sizes else None


def _batch_stride(t) -> int:
    """Element stride between batch rows: 0 for a 2-D operand, which every
    row of a batched launch reads."""
    return int(t.stride(0)) if t.dim() == 3 else 0


def _check_pair(what: str, re, im) -> None:
    if re.shape != im.shape or re.stride() != im.stride():
        raise ValueError(
            f"{what}: real and imaginary parts differ in shape or strides"
        )


# -- the tile engine's launch configuration (csrc/complex_gemm.cuh) -------

#: how the engine copies one operand's stage (``tnc::gemm::Mode``):
#: 16-byte copies along the stride-1 free index; one element per copy with
#: lanes walking the contract index; one element per copy with lanes
#: walking the free index; 16-byte copies along the stride-1 contract index
#: into a K-fastest tile that the staged pipeline transposes
COPY_VEC, COPY_WALK_K, COPY_WALK_F, COPY_VEC_K = 0, 1, 2, 3

#: shared memory one block may use on an H100, in bytes
MAX_SMEM_BYTES = 232_448
#: streaming multiprocessors of an H100 SXM (the default for planning)
H100_SMS = 132


class GemmVariant(NamedTuple):
    """One tile variant of the engine (``Wide``, ``Narrow``, ``Flat``,
    ``Double`` in ``csrc/complex_gemm.cuh``): a ``gm x (256 / gm)`` grid
    of threads, each owning ``tm x tn`` outputs, ``bk`` contract indices
    per stage, ``stages`` stages in the ring."""

    index: int
    dtype: str
    gm: int
    tm: int
    tn: int
    bk: int
    stages: int

    @property
    def bm(self) -> int:
        return self.gm * self.tm

    @property
    def bn(self) -> int:
        return (256 // self.gm) * self.tn


GEMM_VARIANTS = (
    GemmVariant(0, "float32", 16, 8, 4, 32, 3),  # 128 x 64
    GemmVariant(1, "float32", 16, 4, 4, 16, 3),  # 64 x 64
    GemmVariant(2, "float32", 2, 4, 4, 8, 3),    # 8 x 512
    GemmVariant(3, "float64", 16, 4, 4, 16, 3),  # 64 x 64
)
_WIDE, _NARROW, _FLAT, _DOUBLE = GEMM_VARIANTS


class GemmConfig(NamedTuple):
    """A launch of the engine: the variant, its tile (``bm x bn``, ``bk``
    deep), ring depth, elements per 16-byte copy (``vec``) and dynamic
    shared memory in bytes (the kernel sizes its launch from its own
    ``kTileBytes`` / ``kStagedBytes``, which this count mirrors)."""

    variant: int
    bm: int
    bn: int
    bk: int
    stages: int
    vec: int
    smem_bytes: int

    def tiles(self, m: int, n: int) -> int:
        return -(-m // self.bm) * -(-n // self.bn)


def gemm_config(m: int, n: int, itemsize: int, offset_itemsize: int = 0,
                sms: int = H100_SMS, staged: bool = False) -> GemmConfig:
    """The engine's launch configuration for an ``(M, N)`` output of
    ``itemsize``-byte elements; ``offset_itemsize`` is the width of the
    transpose kernel's offset tables (0 for strided operands), whose tile
    rows and columns also live in shared memory. ``staged``: the staged
    pipeline (an operand copied with :data:`COPY_VEC_K`), whose two raw and
    two compute slots replace the ring (``stages`` is then 2).

    float64 takes 64 x 64 tiles. float32 takes 8 x 512 tiles when
    ``M <= 8`` (the outer-product steps, where a 64-row tile would compute
    mostly padding); 128 x 64 tiles when ``M > 64`` and they still give
    every SM a block; else 64 x 64 tiles, so that more blocks fill the
    card.

    >>> gemm_config(8192, 16384, 4)[:5]   # the random28 stem
    (0, 128, 64, 32, 3)
    >>> gemm_config(64, 2048, 4, 4)       # a K = 32 PEPS step
    GemmConfig(variant=1, bm=64, bn=64, bk=16, stages=3, vec=4, smem_bytes=70144)
    >>> gemm_config(2, 2**27, 4)[:3]      # an outer product
    (2, 8, 512)
    """
    if itemsize == 8:
        var = _DOUBLE
    elif itemsize == 4:
        if m <= _FLAT.bm:
            var = _FLAT
        elif m > _NARROW.bm and -(-m // _WIDE.bm) * -(-n // _WIDE.bn) >= sms:
            var = _WIDE
        else:
            var = _NARROW
    else:
        raise ValueError(f"no engine variant for {itemsize}-byte elements")
    vec = 16 // itemsize
    bm, bn = var.bm, var.bn
    pm, pn = bm + vec, bn + vec
    slot = 2 * var.bk * pm + 2 * var.bk * pn
    if staged:
        stages = 2
        compute = 2 * var.bk * pm + 3 * var.bk * pn  # ar ai; br, bi - br, br + bi
        elems = 2 * (slot + compute)
    else:
        stages = var.stages
        elems = stages * slot + 2 * var.bk * (pn + pm)  # + br + bi, ar + ai, two stages
    smem = itemsize * elems + offset_itemsize * (bm + bn)
    return GemmConfig(var.index, bm, bn, var.bk, stages, vec, smem)


_SMS: dict = {}


def _sm_count(device) -> int:
    import torch

    key = torch.device(device).index
    if key not in _SMS:
        _SMS[key] = torch.cuda.get_device_properties(device).multi_processor_count
    return _SMS[key]


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def strided_copy_mode(re, im) -> int:
    """The copy mode of one ``(K, F)`` operand pair (or a batch of them,
    ``(B, K, F)``) read through its strides: 16-byte copies when the free
    index has stride 1, the row stride and the batch stride are whole
    numbers of 16-byte vectors and both parts start 16-byte aligned; else
    element copies, walking the contract index when it has stride 1.

    >>> import torch
    >>> x = torch.zeros(8, 12)
    >>> strided_copy_mode(x, x), strided_copy_mode(x.T, x.T)
    (0, 1)
    >>> strided_copy_mode(x[:, 1:], x[:, 1:])     # misaligned base
    2
    >>> y = torch.zeros(3, 8, 12)
    >>> z = torch.zeros(400).as_strided((3, 8, 12), (97, 12, 1))  # odd batch stride
    >>> strided_copy_mode(y, y), strided_copy_mode(z, z)
    (0, 2)
    """
    vec = 16 // re.element_size()
    sk, sf = re.stride()[-2:]
    if sf == 1 and sk % vec == 0 and _batch_stride(re) % vec == 0 and _aligned(re, im):
        return COPY_VEC
    return COPY_WALK_K if sk == 1 else COPY_WALK_F


# -- single-step fused complex product -------------------------------------


def fused_complex_dot_reference(ar, ai, br, bi):
    """Plain version of :func:`fused_complex_dot`: the naive four
    ``torch.matmul`` lowering (a 2-D operand broadcast over the batch)."""
    return ar.mT @ br - ai.mT @ bi, ar.mT @ bi + ai.mT @ br


def fused_complex_dot(ar, ai, br, bi):
    """``(re, im)`` of the complex product ``(ar+i·ai)ᵀ · (br+i·bi)``.

    ``ar, ai: (K, M)``; ``br, bi: (K, N)``, float32 or float64 (any
    strides, real and imaginary parts alike); outputs ``(M, N)`` of the
    same dtype. Either side may carry a leading slice-batch axis (``(B, K,
    M)`` / ``(B, K, N)``): the outputs are then ``(B, M, N)``, every batch
    row in one launch, a 2-D side read by every row (batch stride 0) —
    the reference's ``vmap`` of ``fused_complex_dot_kl``. CPU tensors run
    :func:`fused_complex_dot_reference`; CUDA tensors launch the kernel on
    the current stream, with the tile variant of :func:`gemm_config` and
    each operand's :func:`strided_copy_mode`.
    """
    _check_parts("fused_complex_dot", (ar, ai, br, bi))
    _check_pair("fused_complex_dot", ar, ai)
    _check_pair("fused_complex_dot", br, bi)
    batch = _batch_of("fused_complex_dot", (ar, br))
    k, m = ar.shape[-2:]
    kb, n = br.shape[-2:]
    if kb != k:
        raise ValueError(f"fused_complex_dot: contract dims differ ({k} vs {kb})")
    if ar.device.type == "cpu":
        return fused_complex_dot_reference(ar, ai, br, bi)
    if batch is not None and not 0 < batch < 65536:
        raise ValueError(f"fused_complex_dot: batch {batch} outside 1..65535")
    out = _launch_complex_dot(ar, ai, br, bi, batch)
    LAUNCHES["fused_complex_dot"] += 1
    return out


def _outputs(m: int, n: int, like, batch: int | None = None):
    """The uninitialised ``(re, im)`` outputs of one launch."""
    import torch

    shape = (m, n) if batch is None else (batch, m, n)
    return tuple(torch.empty(shape, dtype=like.dtype, device=like.device)
                 for _ in range(2))


def _launch_complex_dot(ar, ai, br, bi, batch: int | None = None):
    """One launch of the kernel on checked operands; raises on a CUDA
    error."""
    import torch

    (k, m), n = ar.shape[-2:], br.shape[-1]
    lib = _library("fused_complex_dot")
    fn = (
        lib.tnc_fused_complex_dot_f32
        if ar.dtype == torch.float32
        else lib.tnc_fused_complex_dot_f64
    )
    cfg = gemm_config(m, n, ar.element_size(), sms=_sm_count(ar.device))
    re, im = _outputs(m, n, ar, batch)
    with torch.cuda.device(ar.device):
        rc = fn(
            ar.data_ptr(), ai.data_ptr(), _batch_stride(ar), ar.stride(-2),
            ar.stride(-1), strided_copy_mode(ar, ai),
            br.data_ptr(), bi.data_ptr(), _batch_stride(br), br.stride(-2),
            br.stride(-1), strided_copy_mode(br, bi),
            re.data_ptr(), im.data_ptr(), 1 if batch is None else batch, k, m, n,
            cfg.variant, _stream(ar.device),
        )
    _check(lib, rc, "fused_complex_dot")
    return re, im


# -- fused transpose-dot ----------------------------------------------------


def _tile(dim: int, cap: int, floor: int) -> int | None:
    """Largest tile ≤ ``cap`` that divides ``dim`` and is ≥ ``floor`` (the
    reference's TPU tiling rule, kept for :func:`_plan_transpose_tiles`)."""
    t = min(cap, dim)
    while t >= floor:
        if dim % t == 0:
            return t
        t //= 2
    return None


class OperandLayout:
    """How the raw stored macro view of one dot operand maps onto the
    logical contract-dim-leading ``(K, F)`` matrix the product reads (the
    reference's ``OperandLayout``).

    ``view``: the stored macro view shape (a step's ``a_view`` /
    ``b_view``). ``k_axes`` / ``f_axes``: stored axis ids whose dims merge
    into the flat contract (``K``) and free (``F``) index, each listed most
    significant digit first — in *permuted* order, so decomposing a flat
    index over them recovers the stored coordinates without materialising
    the transpose.
    """

    __slots__ = ("view", "k_axes", "f_axes")

    def __init__(self, view, k_axes, f_axes):
        self.view = tuple(int(d) for d in view)
        self.k_axes = tuple(int(a) for a in k_axes)
        self.f_axes = tuple(int(a) for a in f_axes)

    @property
    def kd(self) -> int:
        """Stored axis carrying the fastest-varying contract digit."""
        return self.k_axes[-1]

    @property
    def fd(self) -> int:
        """Stored axis carrying the fastest-varying free digit."""
        return self.f_axes[-1]

    @property
    def k_size(self) -> int:
        return int(math.prod(self.view[a] for a in self.k_axes))

    @property
    def f_size(self) -> int:
        return int(math.prod(self.view[a] for a in self.f_axes))

    def key(self) -> tuple:
        return (self.view, self.k_axes, self.f_axes)


def operand_layout(view, perm, dot_shape, cfirst) -> OperandLayout | None:
    """The :class:`OperandLayout` of a step operand from its compiler
    fields, or ``None`` when the flat contract dim is not an exact run of
    permuted macro axes (``k = 1``, an empty free side, or a contract dim
    straddling a fused run).

    >>> lay = operand_layout((4, 8, 128), (1, 0, 2), (8, 4, 128), True)
    >>> lay.k_axes, lay.f_axes          # k = axis 1 (dim 8), frees (4, 128)
    ((1,), (0, 2))
    >>> operand_layout((4, 8), None, (4, 8), True).k_axes
    (0,)
    >>> operand_layout((4, 8), None, (1, 32), True) is None   # k == 1
    True
    """
    view = tuple(int(d) for d in view)
    n = len(view)
    order = tuple(perm) if perm is not None else tuple(range(n))
    if sorted(order) != list(range(n)):
        return None
    k = int(dot_shape[0] if cfirst else dot_shape[-1])
    if cfirst:
        k_axes: list[int] = []
        prod = 1
        i = 0
        while prod < k and i < n:
            prod *= view[order[i]]
            k_axes.append(order[i])
            i += 1
        if prod != k:
            return None
        f_axes = list(order[i:])
    else:
        rev: list[int] = []
        prod = 1
        i = n - 1
        while prod < k and i >= 0:
            prod *= view[order[i]]
            rev.append(order[i])
            i -= 1
        if prod != k:
            return None
        k_axes = list(reversed(rev))
        f_axes = list(order[: i + 1])
    if not k_axes or not f_axes:
        return None
    return OperandLayout(view, k_axes, f_axes)


def _plan_transpose_tiles(
    a_lay: OperandLayout, b_lay: OperandLayout
) -> tuple[int, int, int] | None:
    """The reference's ``(tm, tn, tk)`` TPU tiles for one transpose-dot, or
    ``None`` when its floors reject the layouts. The CUDA kernel picks its
    own tiles and takes any shape; the port keeps this only so its gate
    (``tile_floor``) routes the same steps as the reference's."""
    tm = _tile(a_lay.view[a_lay.fd], 128, 8)
    tn = _tile(b_lay.view[b_lay.fd], 128, 128)
    tka = _tile(a_lay.view[a_lay.kd], 512, 8)
    tkb = _tile(b_lay.view[b_lay.kd], 512, 8)
    if tm is None or tn is None or tka is None or tkb is None:
        return None
    tk = math.gcd(tka, tkb)
    if tk < 8:
        return None
    return tm, tn, tk


def transpose_dot_ineligible_reason(
    a_lay: OperandLayout | None,
    b_lay: OperandLayout | None,
    k: int,
    m: int,
    n: int,
) -> str | None:
    """Why :func:`fused_transpose_dot` should not take a step — ``None``
    when it should. The reference's reasons and floors, so both packages
    route the same steps (counted in ``split_complex.FUSED_TRANSPOSE_ROUTED``):

    - ``layout``: a flat dim is not an exact run of permuted macro axes;
    - ``flop_floor``: under :data:`MIN_FLOPS`;
    - ``minor_axes``: an operand's fastest contract and free digits are
      not its two stored minor axes (the kernel relies on one of them
      being stride 1 to read coalesced);
    - ``tile_floor``: the reference's TPU tiles do not fit.

    >>> sq = operand_layout((128, 128), None, (128, 128), True)
    >>> transpose_dot_ineligible_reason(sq, sq, 128, 128, 128) is None
    True
    >>> transpose_dot_ineligible_reason(sq, sq, 16, 16, 16)
    'flop_floor'
    """
    if a_lay is None or b_lay is None:
        return "layout"
    if 2 * k * m * n < MIN_FLOPS:
        return "flop_floor"
    for lay in (a_lay, b_lay):
        nax = len(lay.view)
        if {lay.kd, lay.fd} != {nax - 2, nax - 1}:
            return "minor_axes"
    if _plan_transpose_tiles(a_lay, b_lay) is None:
        return "tile_floor"
    return None


def _as_kf(t, lay: OperandLayout):
    """A stored operand as its logical ``(K, F)`` matrix: view, permute to
    ``k_axes + f_axes``, reshape."""
    return t.reshape(lay.view).permute(lay.k_axes + lay.f_axes).reshape(
        lay.k_size, lay.f_size
    )


def fused_transpose_reference(ar, ai, br, bi, a_layout, b_layout):
    """Plain version of :func:`fused_transpose_dot`: each operand viewed,
    permuted and reshaped to ``(K, F)``, then the four products of
    :func:`fused_complex_dot_reference`."""
    return fused_complex_dot_reference(
        _as_kf(ar, a_layout), _as_kf(ai, a_layout),
        _as_kf(br, b_layout), _as_kf(bi, b_layout),
    )


def offset_dtype(view, strides) -> str:
    """``"int32"`` when every element offset of a tensor of this shape
    and these strides fits 31 bits (the transpose kernel's tables are then
    int32), else ``"int64"``.

    >>> offset_dtype((2, 32, 8192, 32), (2**23, 2**18, 32, 1))
    'int32'
    >>> offset_dtype((2, 2**31), (2**31, 1))
    'int64'
    """
    top = sum((int(d) - 1) * int(s) for d, s in zip(view, strides) if d > 0)
    return "int32" if top < 2**31 else "int64"


def _digit_offsets(sizes, strides, device, dtype: str = "int64"):
    """Stored offset of every flat index over mixed-radix digits of the
    given sizes (most significant first) and element strides: the table
    one side (contract or free) of an operand is read through, of
    ``dtype`` (``int32`` or ``int64``). Built once per (sizes, strides,
    device, dtype) and kept in :data:`_OFFSET_TABLES`."""
    import torch

    key = (tuple(sizes), tuple(strides), device, dtype)
    off = _OFFSET_TABLES.get(key)
    if off is None:
        idx = torch.arange(math.prod(sizes), device=device, dtype=torch.int64)
        off = torch.zeros_like(idx)
        for size, stride in zip(reversed(sizes), reversed(strides)):
            off += (idx % size) * stride
            idx = idx.div(size, rounding_mode="floor")
        off = off.to(getattr(torch, dtype))
        if len(_OFFSET_TABLES) >= _OFFSET_TABLES_MAX:
            _OFFSET_TABLES.clear()
        _OFFSET_TABLES[key] = off
    return off


def _gather_tables(t, lay: OperandLayout, dtype: str | None = None):
    """``(off_k, off_f)``: the contract and free offset tables of one
    stored operand for the kernel, of ``dtype`` (default
    :func:`offset_dtype` of ``t``)."""
    strides = t.stride()
    dtype = dtype or offset_dtype(t.shape, strides)

    def table(axes):
        return _digit_offsets(
            [lay.view[a] for a in axes], [strides[a] for a in axes], t.device, dtype
        )

    return table(lay.k_axes), table(lay.f_axes)


def gather_copy_mode(re, im, lay: OperandLayout, table_dtype: str = "int32") -> int:
    """The copy mode of one stored operand pair read through its offset
    tables. The stride-1 index is walked: the contract index when it has
    the smaller stride (``k_unit``), else the free index. 16-byte copies
    (:data:`COPY_VEC_K` along the contract index, :data:`COPY_VEC` along
    the free one) when that index's fastest digit has stride 1 and a whole
    number of vectors, every other stride is a whole number of vectors and
    both parts start 16-byte aligned (four consecutive indices are then
    one aligned run of the storage); else element copies
    (:data:`COPY_WALK_K`, :data:`COPY_WALK_F`). With int64 offset tables
    (``table_dtype``) the contract index is always copied element-wise:
    the staged pipeline is built for int32 tables only.

    >>> import torch
    >>> t = torch.zeros(2, 32, 32)
    >>> gather_copy_mode(t, t, OperandLayout((2, 32, 32), (1,), (0, 2)))
    0
    >>> gather_copy_mode(t, t, OperandLayout((2, 32, 32), (2,), (0, 1)))
    3
    >>> u = torch.zeros(2, 32, 30)
    >>> gather_copy_mode(u, u, OperandLayout((2, 32, 30), (2,), (0, 1)))
    1
    """
    strides = re.stride()
    k_unit = strides[lay.kd] < strides[lay.fd]
    unit = lay.kd if k_unit else lay.fd
    vec = 16 // re.element_size()
    if (
        strides[unit] == 1
        and not (k_unit and table_dtype == "int64")
        and lay.view[unit] % vec == 0
        and all(s % vec == 0 for ax, s in enumerate(strides)
                if ax != unit and lay.view[ax] > 1)
        and _aligned(re, im)
    ):
        return COPY_VEC_K if k_unit else COPY_VEC
    return COPY_WALK_K if k_unit else COPY_WALK_F


def fused_transpose_dot(ar, ai, br, bi, a_layout, b_layout):
    """``(re, im)`` of the complex product ``Aᵀ·B`` where ``A`` and ``B``
    are the logical ``(K, M)`` / ``(K, N)`` matrices of two stored operands.

    ``ar, ai``: the first operand's raw stored macro view
    (``a_layout.view``-shaped, any strides, real and imaginary parts
    alike), NOT pre-transposed; ``br, bi`` likewise for ``b_layout``.
    Returns the flat ``(M, N)`` pair of the operands' dtype, rows iterating
    the first operand's free digits and columns the second's — the prep +
    dot path's order, so a step reshapes it to ``out_store`` unchanged.
    CPU tensors run :func:`fused_transpose_reference`; CUDA tensors
    (float32 or float64) launch the kernel on the current stream, with the
    offset tables of :func:`offset_dtype`'s width and each operand's
    :func:`gather_copy_mode`.
    """
    what = "fused_transpose_dot"
    _check_parts(what, (ar, ai, br, bi), two_d=False)
    _check_pair(what, ar, ai)
    _check_pair(what, br, bi)
    for t, lay in ((ar, a_layout), (br, b_layout)):
        if tuple(t.shape) != lay.view:
            raise ValueError(
                f"{what}: operand of shape {tuple(t.shape)} for stored view {lay.view}"
            )
        # the kernel's offset tables address the storage only when the
        # contract and free axes split the stored axes between them
        if sorted(lay.k_axes + lay.f_axes) != list(range(len(lay.view))):
            raise ValueError(
                f"{what}: k_axes {lay.k_axes} and f_axes {lay.f_axes} do not "
                f"partition the axes of view {lay.view}"
            )
    k = a_layout.k_size
    if b_layout.k_size != k:
        raise ValueError(
            f"{what}: contract sizes differ ({k} vs {b_layout.k_size})"
        )
    if ar.device.type == "cpu":
        return fused_transpose_reference(ar, ai, br, bi, a_layout, b_layout)
    out = _launch_transpose_dot(ar, ai, br, bi, a_layout, b_layout)
    LAUNCHES[what] += 1
    return out


def _launch_transpose_dot(ar, ai, br, bi, a_layout, b_layout):
    """One launch of the kernel on checked operands; raises on a CUDA
    error."""
    import torch

    k, m, n = a_layout.k_size, a_layout.f_size, b_layout.f_size
    # one table width for both operands: int32 unless an offset needs more
    off = "int32"
    if "int64" in (offset_dtype(ar.shape, ar.stride()), offset_dtype(br.shape, br.stride())):
        off = "int64"
    a_k, a_f = _gather_tables(ar, a_layout, off)
    b_k, b_f = _gather_tables(br, b_layout, off)
    lib = _library("fused_transpose_dot")
    fn = (
        lib.tnc_fused_transpose_dot_f32
        if ar.dtype == torch.float32
        else lib.tnc_fused_transpose_dot_f64
    )
    off_bytes = 8 if off == "int64" else 4
    a_mode = gather_copy_mode(ar, ai, a_layout, off)
    b_mode = gather_copy_mode(br, bi, b_layout, off)
    cfg = gemm_config(m, n, ar.element_size(), off_bytes, _sm_count(ar.device),
                      staged=COPY_VEC_K in (a_mode, b_mode))
    re, im = _outputs(m, n, ar)
    with torch.cuda.device(ar.device):
        rc = fn(
            ar.data_ptr(), ai.data_ptr(), a_k.data_ptr(), a_f.data_ptr(), a_mode,
            br.data_ptr(), bi.data_ptr(), b_k.data_ptr(), b_f.data_ptr(), b_mode,
            re.data_ptr(), im.data_ptr(), k, m, n, int(off == "int64"), cfg.variant,
            _stream(ar.device),
        )
    _check(lib, rc, "fused_transpose_dot")
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
    axis ``yk`` of ``y`` (axes of the last two dimensions, after any batch
    axis): output rows are ``x``'s free axis."""
    x2r, x2i = (xr, xi) if xk == 0 else (xr.mT, xi.mT)
    y2r, y2i = (yr, yi) if yk == 0 else (yr.mT, yi.mT)
    return fused_complex_dot_reference(x2r, x2i, y2r, y2i)


def _chain_compute(vals, links):
    """The chain's arithmetic on plain tensors, in the reference's order
    (``tnc_tpu.ops.pallas_complex._chain_compute``): accumulation in the
    operand dtype. A leading batch axis on any operand carries through."""
    zr, zi = _cdot(vals[0], vals[1], vals[2], vals[3], 0, 0)
    for i, link in enumerate(links):
        cr = vals[4 + 2 * i]
        ci = vals[5 + 2 * i]
        zr = zr.reshape(zr.shape[:-2] + link.carried_shape)
        zi = zi.reshape(zi.shape[:-2] + link.carried_shape)
        if link.carried_first:
            zr, zi = _cdot(zr, zi, cr, ci, link.k_axis, 0)
        else:
            zr, zi = _cdot(cr, ci, zr, zi, 0, link.k_axis)
    return zr, zi


def fused_chain_reference(first_ops, link_ops, links):
    """Plain version of :func:`fused_chain`: the steps one after another
    as ``torch.matmul`` calls (the reference's ``vmap`` of it when an
    operand has a batch axis)."""
    vals = list(first_ops)
    for cr, ci in link_ops:
        vals.extend((cr, ci))
    return _chain_compute(vals, links)


# fields of one stage in the table the chain kernel reads, and the stages
# one launch takes (kFields, kMaxStages in csrc/fused_chain.cu)
_CHAIN_FIELDS = 12
CHAIN_STAGES_PER_LAUNCH = 32
_SCRATCH0, _SCRATCH1, _FINAL = -1, -2, -3


class _ChainPlan:
    """The static stage table of one chain shape: built once, reused by
    every call with the same operand shapes, strides, batch and links.

    One row per stage: ``a_src, a_sk, a_sf, a_sb, b_src, b_sk, b_sf,
    b_sb, K, M, N, c_dst``. A source is an operand pair (>= 0) or a
    scratch pair (-1, -2); the destination a scratch pair or the output
    (-3). ``sb`` is the element stride between batch rows (0 for a 2-D
    operand: every row reads it). Every stage runs all ``batch`` rows and
    writes row ``z`` of its ``(M, N)`` result at ``z * M * N``, so a
    carried value's batch stride is its own size."""

    __slots__ = ("table", "n_stages", "scratch_elems", "out_shape", "batch")

    def __init__(self, first_ops, link_ops, links):
        import numpy as np

        fr, _, sr, _ = first_ops
        k0, m0 = fr.shape[-2:]
        n0 = sr.shape[-1]
        flat = list(first_ops) + [t for pair in link_ops for t in pair]
        self.batch = _batch_of("fused_chain", flat)
        rows = []
        # head: operand pairs 0 (first) and 1 (second)
        shape = (m0, n0)
        scratch = m0 * n0
        dst = _SCRATCH0 if links else _FINAL
        rows.append([0, fr.stride(-2), fr.stride(-1), _batch_stride(fr),
                     1, sr.stride(-2), sr.stride(-1), _batch_stride(sr),
                     k0, m0, n0, dst])
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
            kc, x = cr.shape[-2:]
            if kc != k:
                raise ValueError(
                    f"fused_chain: link {i} contracts {k} against {kc}"
                )
            pair = 2 + i
            carried = [src, z_sk, z_sf, r * c]
            other = [pair, cr.stride(-2), cr.stride(-1), _batch_stride(cr)]
            if link.carried_first:
                rows.append(carried + other + [k, f, x, dst])
            else:
                rows.append(other + carried + [k, x, f, dst])
            shape = link.out_shape(x)
            if dst != _FINAL:
                scratch = max(scratch, shape[0] * shape[1])
        self.table = np.ascontiguousarray(rows, dtype=np.int64)
        self.n_stages = len(rows)
        self.scratch_elems = scratch if links else 0
        self.out_shape = shape if self.batch is None else (self.batch,) + shape


def _chain_plan(first_ops, link_ops, links) -> _ChainPlan:
    flat = list(first_ops) + [t for pair in link_ops for t in pair]
    key = (
        first_ops[0].dtype,
        tuple((tuple(t.shape), t.stride()) for t in flat[::2]),
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
    and imaginary parts alike). Any operand may carry a leading
    slice-batch axis ``(B, K, X)``: the chain then runs for every batch
    row in the same launch (a 2-D operand read by every row) and the
    result is ``(B, rows, cols)`` — the reference's ``vmap`` of
    ``fused_chain_kl``. Returns the chain's final ``(re, im)`` pair, of
    the operands' dtype.

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
    if fr.shape[-2] != sr.shape[-2]:
        raise ValueError("fused_chain: head contract dims differ")
    plan = _chain_plan(first_ops, link_ops, links)
    if fr.device.type == "cpu":
        return fused_chain_reference(first_ops, link_ops, links)
    lib = _library("fused_chain")
    dtype, device = fr.dtype, fr.device
    batch = 1 if plan.batch is None else plan.batch
    fn = lib.tnc_fused_chain_f32 if dtype == torch.float32 else lib.tnc_fused_chain_f64
    out_r = torch.empty(plan.out_shape, dtype=dtype, device=device)
    out_i = torch.empty(plan.out_shape, dtype=dtype, device=device)
    stride = batch * max(plan.scratch_elems, 1)
    scratch = torch.empty((4 * stride,), dtype=dtype, device=device)
    ptrs = (ctypes.c_void_p * len(flat))(*[t.data_ptr() for t in flat])
    with torch.cuda.device(device):
        rc = fn(
            ptrs, plan.table.ctypes.data, plan.n_stages, batch, scratch.data_ptr(),
            stride, out_r.data_ptr(), out_i.data_ptr(), _stream(device),
        )
    _check(lib, rc, "fused_chain")
    LAUNCHES["fused_chain"] += -(-plan.n_stages // CHAIN_STAGES_PER_LAUNCH)
    return out_r, out_i
