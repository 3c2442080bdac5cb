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
  :func:`tnc_tpu_torch.ops.program.chain_groups`) as one launch — the
  counterpart of ``fused_chain_kl``: one block a batch row with the carried
  value in shared memory where it fits, else a cooperative grid with the
  carried value in L2 scratch; planned once per chain shape
  (:func:`chain_plan`).

``fused_complex_dot`` and ``fused_chain`` also take a leading slice-batch
axis (``(B, K, X)`` operands beside 2-D ones, which every batch row
shares through a batch stride of 0): the chunked sliced executor's
batch, in one launch — the reference's ``vmap`` of its kernels.

The two single-product kernels share one pipelined tile engine
(``csrc/complex_gemm.cuh``: a ``cp.async`` ring, 128-bit fragment loads,
three real products per complex multiply-add); this module chooses its
launch configuration (:func:`gemm_config`) and each operand's copy mode
(:func:`strided_copy_mode`, :func:`gather_copy_mode`), so that choice is
tested on the CPU, as it chooses each chain stage's thread shape
(:func:`chain_stage_shape`, :func:`chain_k_blocks`).

Beside each kernel is its plain version (:func:`fused_complex_dot_reference`,
:func:`fused_transpose_reference`, :func:`fused_chain_reference`). A
wrapper given CPU tensors runs the plain
version: that is the CPU implementation. Given CUDA tensors it launches the
kernel or raises; nothing here falls back from the kernel to the plain
version. :data:`LAUNCHES` counts the kernel launches per kernel (plain
versions are not counted), so a run can show it went through the kernels;
:data:`CHAIN_FORMS` counts the chain's launches per form.

Every wrapper and plain version takes the reference's ``precision``: the
dot-precision rung (``split_complex.RUNGS``) a float32 call computes. At
``float32`` (the default) the arithmetic is FP32 (or FP64) FMA on the CUDA
cores; at ``high`` (3xTF32) and ``default`` (one TF32 pass) the two
single-product kernels run the TF32 tile of ``csrc/tf32_tile.cuh``
(``wgmma`` on operands rounded once to TF32 into K-major shared-memory
tiles, TMA or ``cp.async`` loads behind an ``mbarrier`` ring) on launches
of :data:`TF32_WGMMA_MIN_MACS` multiply-adds or more, and the tile
engine's ``mma.sync`` tiles below that and on the outer products (both
mirrored by :data:`TF32_TILES` and chosen by :func:`tf32_config`), and the chain
kernel its FMA loop on rounded
operands; the plain versions round the same values in FP32 torch ops
(``split_complex.rung_matmul``). float64 ignores the rung.
:data:`RUNG_LAUNCHES` counts the launches per kernel and rung,
:data:`TILE_LAUNCHES` the TF32 launches per kernel, rung and tile.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import threading
from array import array
from pathlib import Path
from typing import NamedTuple

MIN_FLOPS = 1 << 22  # below this a single step is launch-dominated

#: budget of a fused chain, in float32 elements summed over every operand
#: and intermediate the chain touches ((real, imag) pairs count double).
#: Kept at the reference's value so :func:`~tnc_tpu_torch.ops.program.
#: chain_groups` forms the same chains as the JAX package; a chain whose
#: carried values do not fit one block's shared memory runs in the chain
#: kernel's grid form, so the bound is not a shared-memory limit here.
CHAIN_MAX_ELEMS = 1 << 20

#: kernel launches per kernel since the last :func:`reset_launches`
LAUNCHES: dict[str, int] = {
    "fused_chain": 0, "fused_complex_dot": 0, "fused_transpose_dot": 0,
}

#: the kernels' code of each dot-precision rung (``tnc::gemm::Rung``)
RUNG_CODES = {"float32": 0, "high": 1, "default": 2}

#: kernel launches per ``"<kernel> <rung>"`` since the last
#: :func:`reset_launches` (float64 launches count as ``float32``)
RUNG_LAUNCHES: dict[str, int] = {}

#: TF32-rung launches per ``"<kernel> <rung> <tile>"`` (a :data:`TF32_TILES`
#: name) since the last :func:`reset_launches`
TILE_LAUNCHES: dict[str, int] = {}

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
_SOURCES = {
    "fused_complex_dot": "fused_complex_dot.cu",
    "fused_chain": "fused_chain.cu",
    "fused_transpose_dot": "fused_transpose_dot.cu",
}
_HEADERS = ("complex_gemm.cuh", "tf32_tile.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
    # each source instantiates its kernel at every tile variant and rung:
    # optimise and assemble them on every core, not one per source
    "--split-compile=0",
)

#: ``ptxas -v`` output (registers, shared memory, spills) of each kernel's
#: library, by kernel name: from the build, or kept beside a library built
#: earlier
BUILD_LOG: dict[str, str] = {}

_LIBS: dict[str, ctypes.CDLL] = {}
_LIB_LOCK = threading.Lock()
# the transpose kernel's offset tables, by (digit sizes, strides, device)
_OFFSET_TABLES: dict[tuple, object] = {}
_OFFSET_TABLES_MAX = 256
# the keys of tables a CUDA graph capture has read: never evicted
_CAPTURED_TABLES: set[tuple] = set()


def reset_launches() -> None:
    """Set every kernel's launch count, the chain's count per form and the
    counts per rung to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    for form in CHAIN_FORMS:
        CHAIN_FORMS[form] = 0
    RUNG_LAUNCHES.clear()
    TILE_LAUNCHES.clear()


def _rung(precision, dtype) -> str:
    """The rung a call of ``dtype`` parts runs at: the resolved
    ``precision`` for float32, ``float32`` for anything else (float64
    ignores the rung)."""
    import torch

    from tnc_tpu_torch.ops.split_complex import _resolve_precision

    return _resolve_precision(precision) if dtype == torch.float32 else "float32"


def _count(name: str, rung: str, n: int = 1, tile: str | None = None) -> None:
    LAUNCHES[name] += n
    key = f"{name} {rung}"
    RUNG_LAUNCHES[key] = RUNG_LAUNCHES.get(key, 0) + n
    if tile is not None:
        key = f"{name} {rung} {tile}"
        TILE_LAUNCHES[key] = TILE_LAUNCHES.get(key, 0) + n


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
        lib = bind_library(name, build_kernels()[name])
        _LIBS[name] = lib
        return lib


def bind_library(name: str, path) -> ctypes.CDLL:
    """Load kernel ``name``'s shared library from ``path`` and declare its
    C entries. (A library built with other flags, as
    ``scripts/tf32_drift.py`` builds one at each TF32 chain depth, is put
    in place with ``_LIBS[name] = bind_library(name, path)``.)"""
    lib = ctypes.CDLL(str(path))
    lib.tnc_error_string.argtypes = [_I]
    lib.tnc_error_string.restype = ctypes.c_char_p
    # the float entries take the rung before the stream; double does not
    if name == "fused_complex_dot":
        head = [_P, _P, _LL, _LL, _LL, _I, _P, _P, _LL, _LL, _LL, _I,
                _P, _P, _I, _LL, _LL, _LL, _I]
        lib.tnc_fused_complex_dot_f32.argtypes = head + [_I, _P]
        lib.tnc_fused_complex_dot_f64.argtypes = head + [_P]
        fns = (lib.tnc_fused_complex_dot_f32, lib.tnc_fused_complex_dot_f64)
    elif name == "fused_transpose_dot":
        head = [_P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _P, _P, _LL, _LL, _LL, _I, _I]
        lib.tnc_fused_transpose_dot_f32.argtypes = head + [_I, _P]
        lib.tnc_fused_transpose_dot_f64.argtypes = head + [_P]
        fns = (lib.tnc_fused_transpose_dot_f32, lib.tnc_fused_transpose_dot_f64)
    else:
        lib.tnc_fused_chain_f32.argtypes = [_P, _I, _P, _I, _P]
        lib.tnc_fused_chain_f64.argtypes = [_P, _I, _P, _P]
        fns = (lib.tnc_fused_chain_f32, lib.tnc_fused_chain_f64)
    for fn in fns:
        fn.restype = _I
    if name == "fused_chain":
        lib.tnc_chain_empty_launch.argtypes = [_I, _I, _P]
        lib.tnc_chain_empty_launch.restype = _I
        abi = (lib.tnc_chain_header_fields, lib.tnc_chain_table_fields,
               lib.tnc_chain_max_stages, lib.tnc_chain_max_ptrs)
        for fn in abi:
            fn.restype = _I
        if tuple(fn() for fn in abi) != (
            _CHAIN_HEADER, _CHAIN_FIELDS, CHAIN_STAGES_PER_LAUNCH, _CHAIN_MAX_PTRS
        ):
            raise RuntimeError("fused_chain library and wrapper disagree")
    return lib


def _check(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.tnc_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel failed: CUDA error {rc} ({msg})")


def _stream(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def _raw_stream(device) -> int:
    """:func:`_stream` through PyTorch's raw-handle query where it has one,
    which builds no ``Stream`` object (the chain's per-call path)."""
    import torch

    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    return raw(device.index) if raw is not None else _stream(device)


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
#: the TF32 tile's TMA boxes (``tf32::kTma``): its launcher takes them for a
#: :data:`COPY_VEC` operand of ``fused_complex_dot`` whose rows do not overlap
COPY_TMA = 4

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
    ``kTileBytes`` / ``kStagedBytes``, which this count mirrors). The
    TF32 rungs launch another tile: :func:`tf32_config`."""

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


class Tf32Tile(NamedTuple):
    """One tile of the TF32 rungs (``csrc/tf32_tile.cuh``: ``Wide`` and
    ``WideHigh``, ``FlatN``; ``csrc/complex_gemm.cuh``'s mma.sync
    ``FlatTc``, ``WideTc``, ``NarrowTc``): ``xr`` rows of ``wgmma`` (groups
    of 64) from the X operand, ``yc`` columns (its N) from the Y operand;
    X is A (the output's rows) unless ``swap``, where the tile computes Cᵀ;
    at each TF32 rung ``bk_*`` contract indices a stage and ``raw_*`` raw
    slots in the load ring (the stages the loads run ahead)."""

    index: int
    name: str
    xr: int
    yc: int
    swap: bool
    bk_default: int
    bk_high: int
    raw_default: int
    raw_high: int

    @property
    def bm(self) -> int:
        return self.yc if self.swap else self.xr

    @property
    def bn(self) -> int:
        return self.xr if self.swap else self.yc


TF32_TILES = (
    # the wgmma tile (csrc/tf32_tile.cuh)
    Tf32Tile(0, "wide", 64, 128, False, 32, 16, 2, 5),
    Tf32Tile(1, "flat_n", 256, 8, False, 16, 16, 4, 2),   # N <= 8
    # complex_gemm.cuh's mma.sync tiles (FlatTc, WideTc, NarrowTc: a
    # three-stage cp.async ring, 256 threads), for the classes tf32_config
    # routes there; xr is the tile's output rows (columns for the
    # transposed mma_flat), raw its ring's stages
    Tf32Tile(2, "mma_flat", 512, 8, True, 8, 8, 3, 3),
    Tf32Tile(3, "mma_wide", 128, 64, False, 32, 32, 3, 3),
    Tf32Tile(4, "mma_narrow", 64, 64, False, 16, 16, 3, 3),
)
_TF32_BY_NAME = {t.name: t for t in TF32_TILES}
#: the mma.sync tiles' row padding of the A and B tiles (``PadM_``,
#: ``PadN_`` of their ``Variant``s), in floats
_MMA_PADS = {"mma_flat": (16, 8), "mma_wide": (8, 8), "mma_narrow": (8, 8)}
#: a TF32 launch of fewer complex multiply-adds (batch rows included) keeps
#: the mma.sync tiles: below it neither tile wins throughout, above it the
#: wgmma tile ran every launch but the outer products faster on an H100
#: (``scripts/tf32_tile_shapes.py --tiles`` times both on the same launch)
TF32_WGMMA_MIN_MACS = 1 << 30
#: the kernels' threads at a TF32 rung: two consumer warpgroups, one loading
TF32_THREADS = 384


class Tf32Config(NamedTuple):
    """A TF32-rung launch: the tile, its output tile (``bm x bn``), stage
    depth ``bk``, raw slots ``raw`` and dynamic shared memory in bytes (the
    raw slots and two compute slots, a hi and, at ``high``, a lo level
    each, of the operands' parts in whole 1 KB swizzle atoms; the
    mbarriers, the 1 KB alignment slack and the transpose kernel's offset
    tables), as the kernel sizes its launch (``tf32::kTileBytes``)."""

    variant: int
    name: str
    bm: int
    bn: int
    bk: int
    raw: int
    smem_bytes: int

    def tiles(self, m: int, n: int) -> int:
        return -(-m // self.bm) * -(-n // self.bn)


def wgmma_tile(m: int, n: int) -> str:
    """The wgmma tile of an ``(M, N)`` output: ``flat_n`` when ``N <= 8``,
    else ``wide``."""
    return "flat_n" if n <= 8 else "wide"


def mma_tile(m: int, n: int, sms: int = H100_SMS) -> str:
    """The mma.sync tile of an ``(M, N)`` output, chosen as
    :func:`gemm_config` chooses the FMA engine's: ``mma_flat`` when ``M <=
    8``, ``mma_wide`` when ``M > 64`` and its tiles give every SM a block,
    else ``mma_narrow``."""
    wide = _TF32_BY_NAME["mma_wide"]
    if m <= 8:
        return "mma_flat"
    if m > 64 and -(-m // wide.bm) * -(-n // wide.bn) >= sms:
        return "mma_wide"
    return "mma_narrow"


def tf32_config(k: int, m: int, n: int, rung: str, offset_itemsize: int = 0,
                staged: bool = False, batch: int = 1, sms: int = H100_SMS,
                tile: str | None = None) -> Tf32Config:
    """The TF32 tile of a ``(K, M) x (K, N)`` product (``batch`` rows) at
    ``rung`` (``high`` or ``default``): ``tile`` (a :data:`TF32_TILES`
    name) if given, else :func:`mma_tile`'s for three classes and
    :func:`wgmma_tile`'s for the rest (64 x 128 ``wide`` outputs; 32
    contract indices a stage at ``default``, 16 at ``high``, whose compute
    slots hold hi and lo tiles). The classes, at both rungs: under
    :data:`TF32_WGMMA_MIN_MACS` multiply-adds; ``M <= 8`` (the outer
    products, which the wgmma tile's transposed form ran 1.06-1.51x slower
    on an H100, so it is not built); int64 offset tables (the wgmma
    transpose kernel reads int32 ones).
    ``offset_itemsize``: the transpose kernel's table width (0:
    ``fused_complex_dot``); ``staged``: its staged pipeline (a
    ``COPY_VEC_K`` operand; an mma.sync tile's shared memory depends on it).

    >>> tf32_config(16384, 8192, 16384, "default")   # the random28 stem
    Tf32Config(variant=0, name='wide', bm=64, bn=128, bk=32, raw=2, smem_bytes=197888)
    >>> tf32_config(16384, 8192, 16384, "high", 4)[:6]
    (0, 'wide', 64, 128, 16, 5)
    >>> tf32_config(2, 2, 2**27, "high")[:4]    # an outer product
    (2, 'mma_flat', 8, 512)
    >>> tf32_config(1024, 64, 2048, "default")[:4]
    (4, 'mma_narrow', 64, 64)
    >>> tf32_config(2**20, 8, 2**10, "high")[:4]   # 2^33 multiply-adds, M <= 8
    (2, 'mma_flat', 8, 512)
    """
    if rung not in ("high", "default"):
        raise ValueError(f"no TF32 tile at rung {rung!r}")
    if tile is None:
        small = k * m * n * batch < TF32_WGMMA_MIN_MACS or m <= 8 or offset_itemsize == 8
        tile = mma_tile(m, n, sms) if small else wgmma_tile(m, n)
    t = _TF32_BY_NAME[tile]
    if t.name.startswith("mma"):
        # complex_gemm.cuh's kTcTileBytes / kTcStagedBytes: the ring's three
        # slots (or two raw and two compute slots) of the four parts, rows
        # padded by _MMA_PADS
        pad_m, pad_n = _MMA_PADS[t.name]
        bk = t.bk_default
        slot = 2 * bk * (t.bm + pad_m) + 2 * bk * (t.bn + pad_n)
        smem = 4 * (4 if staged else 3) * slot + offset_itemsize * (t.bm + t.bn)
        return Tf32Config(t.index, t.name, t.bm, t.bn, bk, t.raw_default, smem)
    high = rung == "high"
    bk, raw = (t.bk_high, t.raw_high) if high else (t.bk_default, t.raw_default)
    levels = 2 if high else 1

    def part(rows):
        return -(-rows * bk * 4 // 1024) * 1024

    slot = 2 * part(t.xr) + 2 * part(t.yc)
    smem = (1024 + raw * slot + 2 * levels * slot + 256
            + offset_itemsize * (t.xr + t.yc))
    return Tf32Config(t.index, t.name, t.bm, t.bn, bk, raw, smem)


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


def fused_complex_dot_reference(ar, ai, br, bi, precision=None):
    """Plain version of :func:`fused_complex_dot`: the naive four
    ``torch.matmul`` lowering (a 2-D operand broadcast over the batch),
    each product at the rung ``precision``
    (``split_complex.rung_matmul``; ``None`` is full FP32)."""
    rung = _rung(precision, ar.dtype)
    if rung == "float32":
        return ar.mT @ br - ai.mT @ bi, ar.mT @ bi + ai.mT @ br
    from tnc_tpu_torch.ops.split_complex import rung_matmul

    re = rung_matmul(ar.mT, br, rung)
    re -= rung_matmul(ai.mT, bi, rung)
    im = rung_matmul(ar.mT, bi, rung)
    im += rung_matmul(ai.mT, br, rung)
    return re, im


def fused_complex_dot(ar, ai, br, bi, precision=None, *, tile=None):
    """``(re, im)`` of the complex product ``(ar+i·ai)ᵀ · (br+i·bi)``.

    ``ar, ai: (K, M)``; ``br, bi: (K, N)``, float32 or float64 (any
    strides, real and imaginary parts alike); outputs ``(M, N)`` of the
    same dtype. Either side may carry a leading slice-batch axis (``(B, K,
    M)`` / ``(B, K, N)``): the outputs are then ``(B, M, N)``, every batch
    row in one launch, a 2-D side read by every row (batch stride 0) —
    the reference's ``vmap`` of ``fused_complex_dot_kl``. ``precision``:
    the dot-precision rung of a float32 call (``float32`` / ``None``, the
    FMA engine; ``high``, 3xTF32; ``default``, one TF32 pass, both on the
    tensor cores). CPU tensors run :func:`fused_complex_dot_reference` at
    that rung; CUDA tensors launch the kernel at it on the current stream,
    with the tile variant of :func:`gemm_config` (at a TF32 rung
    :func:`tf32_config`'s, or the :data:`TF32_TILES` one named by
    ``tile``) and each operand's :func:`strided_copy_mode`.
    """
    _check_tile(tile, precision)
    _check_parts("fused_complex_dot", (ar, ai, br, bi))
    _check_pair("fused_complex_dot", ar, ai)
    _check_pair("fused_complex_dot", br, bi)
    batch = _batch_of("fused_complex_dot", (ar, br))
    k, m = ar.shape[-2:]
    kb, n = br.shape[-2:]
    if kb != k:
        raise ValueError(f"fused_complex_dot: contract dims differ ({k} vs {kb})")
    rung = _rung(precision, ar.dtype)
    if ar.device.type == "cpu":
        return fused_complex_dot_reference(ar, ai, br, bi, rung)
    if batch is not None and not 0 < batch < 65536:
        raise ValueError(f"fused_complex_dot: batch {batch} outside 1..65535")
    pieces, cfg = 1, None
    if rung != "float32":
        sms = _sm_count(ar.device)
        cfg = tf32_config(k, m, n, rung, batch=batch or 1, sms=sms, tile=tile)
        pieces = split_k_pieces(k, cfg.tiles(m, n), batch or 1, sms)
    if pieces == 1:
        out = _launch_complex_dot(ar, ai, br, bi, batch, rung, cfg)
    else:
        parts = split_contraction((ar, ai, br, bi), batch, pieces)
        re, im = _launch_complex_dot(*parts, (batch or 1) * pieces, rung, cfg)
        out = tuple(merge_pieces(t, batch, pieces) for t in (re, im))
    _count("fused_complex_dot", rung, tile=None if cfg is None else cfg.name)
    return out


def _check_tile(tile, precision) -> None:
    """A wrapper's ``tile``: ``None``, or a :data:`TF32_TILES` name at a
    TF32 rung."""
    if tile is None:
        return
    if precision not in ("high", "default"):
        raise ValueError(f"tile {tile!r} at rung {precision!r}: tiles are the TF32 rungs'")
    if tile not in {t.name for t in TF32_TILES}:
        raise ValueError(f"no TF32 tile {tile!r}")


#: a split contraction's pieces are at least this many contract indices
SPLIT_K_MIN = 2048


def split_k_pieces(k: int, tiles: int, batch: int, sms: int = H100_SMS) -> int:
    """Pieces a TF32-rung :func:`fused_complex_dot` cuts its contraction
    into, each a row of one batched launch: 1 when the output's ``tiles``
    (:func:`tf32_config`'s) times the ``batch`` already give every SM four
    work items (the tile's blocks are persistent, one an SM), else the least
    power of two that does, while it divides ``k``, leaves pieces of at
    least :data:`SPLIT_K_MIN` indices and keeps the grid's rows within
    65535. A block walks its whole contraction one stage after another, so
    a long dot to a small output (the sliced m10's ``(K=2^23, M=1, N=1)``)
    would otherwise run on a few SMs. (``float32`` launches are never cut:
    their bits stay what they were.)

    >>> split_k_pieces(2**23, 1, 8)
    128
    >>> split_k_pieces(16384, 128 * 256, 1), split_k_pieces(1024, 1, 1)
    (1, 1)

    Shorter pieces (512) made a call of ``K <= 2048`` up to twice as slow
    on an H100 (the cut, the FP32 sum and a second launch), and won only
    where a long dot has one output tile (``K = 65536, M = N = 1``;
    ``scripts/tf32_tile_shapes.py --tiles``).
    """
    pieces = 1
    while (tiles * batch * pieces < 4 * sms and k % (2 * pieces) == 0
           and k // (2 * pieces) >= SPLIT_K_MIN and batch * 2 * pieces <= 65535):
        pieces *= 2
    return pieces


def split_contraction(parts, batch: int | None, pieces: int):
    """``(ar, ai, br, bi)`` with the contraction cut into ``pieces``: each
    part ``(batch * pieces, K / pieces, free)``, row ``b * pieces + p``
    piece ``p`` of batch row ``b`` (a 2-D side is read by every batch row,
    so it is expanded first). A view where the strides allow, else a
    copy."""
    out = []
    for t in parts:
        k, f = t.shape[-2:]
        if batch is not None and t.dim() == 2:
            t = t.expand(batch, k, f)
        out.append(t.reshape(-1, k // pieces, f))
    return tuple(out)


def merge_pieces(t, batch: int | None, pieces: int):
    """The sum over the pieces of a split launch's output ``t``, ``(batch *
    pieces, M, N)``, in FP32: ``(M, N)``, or ``(batch, M, N)``."""
    t = t.reshape(batch or 1, pieces, *t.shape[-2:]).sum(1)
    return t if batch is not None else t[0]


def _outputs(m: int, n: int, like, batch: int | None = None):
    """The uninitialised ``(re, im)`` outputs of one launch."""
    import torch

    shape = (m, n) if batch is None else (batch, m, n)
    return tuple(torch.empty(shape, dtype=like.dtype, device=like.device)
                 for _ in range(2))


def _launch_complex_dot(ar, ai, br, bi, batch: int | None = None,
                        rung: str = "float32", cfg: "Tf32Config | None" = None):
    """One launch of the kernel on checked operands at ``rung`` (float32
    parts; float64 takes ``float32``), at a TF32 rung on ``cfg``'s tile;
    raises on a CUDA error."""
    import torch

    (k, m), n = ar.shape[-2:], br.shape[-1]
    lib = _library("fused_complex_dot")
    if rung == "float32":
        variant = gemm_config(m, n, ar.element_size(), sms=_sm_count(ar.device)).variant
    else:
        variant = cfg.variant
    re, im = _outputs(m, n, ar, batch)
    args = (
        ar.data_ptr(), ai.data_ptr(), _batch_stride(ar), ar.stride(-2),
        ar.stride(-1), strided_copy_mode(ar, ai),
        br.data_ptr(), bi.data_ptr(), _batch_stride(br), br.stride(-2),
        br.stride(-1), strided_copy_mode(br, bi),
        re.data_ptr(), im.data_ptr(), 1 if batch is None else batch, k, m, n,
        variant,
    )
    with torch.cuda.device(ar.device):
        if ar.dtype == torch.float32:
            rc = lib.tnc_fused_complex_dot_f32(*args, RUNG_CODES[rung], _stream(ar.device))
        else:
            rc = lib.tnc_fused_complex_dot_f64(*args, _stream(ar.device))
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


def fused_transpose_reference(ar, ai, br, bi, a_layout, b_layout, precision=None):
    """Plain version of :func:`fused_transpose_dot`: each operand viewed,
    permuted and reshaped to ``(K, F)``, then the four products of
    :func:`fused_complex_dot_reference` at the rung ``precision``."""
    return fused_complex_dot_reference(
        _as_kf(ar, a_layout), _as_kf(ai, a_layout),
        _as_kf(br, b_layout), _as_kf(bi, b_layout), precision,
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
    device, dtype) and kept in :data:`_OFFSET_TABLES`; a table read under
    a CUDA graph capture is never evicted, since the graph reads it by
    address at every replay, and one first needed under a capture is
    refused (it would hold its values only after a replay: an executor
    runs each unit eagerly before capturing it)."""
    import torch

    key = (tuple(sizes), tuple(strides), device, dtype)
    capturing = torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()
    off = _OFFSET_TABLES.get(key)
    if off is not None:
        if capturing:
            _CAPTURED_TABLES.add(key)
    else:
        if capturing:
            raise RuntimeError("fused_transpose_dot: an offset table was first "
                               "needed inside a CUDA graph capture")
        idx = torch.arange(math.prod(sizes), device=device, dtype=torch.int64)
        off = torch.zeros_like(idx)
        for size, stride in zip(reversed(sizes), reversed(strides)):
            off += (idx % size) * stride
            idx = idx.div(size, rounding_mode="floor")
        off = off.to(getattr(torch, dtype))
        if len(_OFFSET_TABLES) >= _OFFSET_TABLES_MAX:
            for stale in set(_OFFSET_TABLES) - _CAPTURED_TABLES:
                del _OFFSET_TABLES[stale]
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


def fused_transpose_dot(ar, ai, br, bi, a_layout, b_layout, precision=None, *, tile=None):
    """``(re, im)`` of the complex product ``Aᵀ·B`` where ``A`` and ``B``
    are the logical ``(K, M)`` / ``(K, N)`` matrices of two stored operands.

    ``ar, ai``: the first operand's raw stored macro view
    (``a_layout.view``-shaped, any strides, real and imaginary parts
    alike), NOT pre-transposed; ``br, bi`` likewise for ``b_layout``.
    Returns the flat ``(M, N)`` pair of the operands' dtype, rows iterating
    the first operand's free digits and columns the second's — the prep +
    dot path's order, so a step reshapes it to ``out_store`` unchanged.
    ``precision``: the dot-precision rung of a float32 call, as for
    :func:`fused_complex_dot`. CPU tensors run
    :func:`fused_transpose_reference` at that rung; CUDA tensors (float32
    or float64) launch the kernel at it on the current stream, with the
    offset tables of :func:`offset_dtype`'s width and each operand's
    :func:`gather_copy_mode`; at a TF32 rung on :func:`tf32_config`'s tile,
    or the :data:`TF32_TILES` one named by ``tile``.
    """
    _check_tile(tile, precision)
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
    rung = _rung(precision, ar.dtype)
    if ar.device.type == "cpu":
        return fused_transpose_reference(ar, ai, br, bi, a_layout, b_layout, rung)
    re, im, cfg = _launch_transpose_dot(ar, ai, br, bi, a_layout, b_layout, rung, tile)
    _count(what, rung, tile=None if cfg is None else cfg.name)
    return re, im


def _launch_transpose_dot(ar, ai, br, bi, a_layout, b_layout, rung: str = "float32",
                          tile: str | None = None):
    """One launch of the kernel on checked operands at ``rung`` (float32
    parts; float64 takes ``float32``): ``(re, im, cfg)``, ``cfg`` the TF32
    launch's :class:`Tf32Config` (``None`` at ``float32``); raises on a CUDA
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
    off_bytes = 8 if off == "int64" else 4
    a_mode = gather_copy_mode(ar, ai, a_layout, off)
    b_mode = gather_copy_mode(br, bi, b_layout, off)
    cfg = None
    if rung == "float32":
        variant = gemm_config(m, n, ar.element_size(), off_bytes, _sm_count(ar.device),
                              staged=COPY_VEC_K in (a_mode, b_mode)).variant
    else:
        cfg = tf32_config(k, m, n, rung, off_bytes, COPY_VEC_K in (a_mode, b_mode),
                          sms=_sm_count(ar.device), tile=tile)
        variant = cfg.variant
    re, im = _outputs(m, n, ar)
    args = (
        ar.data_ptr(), ai.data_ptr(), a_k.data_ptr(), a_f.data_ptr(), a_mode,
        br.data_ptr(), bi.data_ptr(), b_k.data_ptr(), b_f.data_ptr(), b_mode,
        re.data_ptr(), im.data_ptr(), k, m, n, int(off == "int64"), variant,
    )
    with torch.cuda.device(ar.device):
        if ar.dtype == torch.float32:
            rc = lib.tnc_fused_transpose_dot_f32(*args, RUNG_CODES[rung],
                                                 _stream(ar.device))
        else:
            rc = lib.tnc_fused_transpose_dot_f64(*args, _stream(ar.device))
    _check(lib, rc, "fused_transpose_dot")
    return re, im, cfg


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


def _cdot(xr, xi, yr, yi, xk: int, yk: int, precision=None):
    """Naive split-complex product contracting axis ``xk`` of ``x`` with
    axis ``yk`` of ``y`` (axes of the last two dimensions, after any batch
    axis) at the rung ``precision``: output rows are ``x``'s free axis."""
    x2r, x2i = (xr, xi) if xk == 0 else (xr.mT, xi.mT)
    y2r, y2i = (yr, yi) if yk == 0 else (yr.mT, yi.mT)
    return fused_complex_dot_reference(x2r, x2i, y2r, y2i, precision)


def _chain_compute(vals, links, precision=None):
    """The chain's arithmetic on plain tensors, in the reference's order
    (``tnc_tpu.ops.pallas_complex._chain_compute``): accumulation in the
    operand dtype, every product at the rung ``precision`` (the carried
    value rounded again where the next step reads it). A leading batch
    axis on any operand carries through."""
    zr, zi = _cdot(vals[0], vals[1], vals[2], vals[3], 0, 0, precision)
    for i, link in enumerate(links):
        cr = vals[4 + 2 * i]
        ci = vals[5 + 2 * i]
        zr = zr.reshape(zr.shape[:-2] + link.carried_shape)
        zi = zi.reshape(zi.shape[:-2] + link.carried_shape)
        if link.carried_first:
            zr, zi = _cdot(zr, zi, cr, ci, link.k_axis, 0, precision)
        else:
            zr, zi = _cdot(cr, ci, zr, zi, 0, link.k_axis, precision)
    return zr, zi


def fused_chain_reference(first_ops, link_ops, links, precision=None):
    """Plain version of :func:`fused_chain`: the steps one after another
    as ``torch.matmul`` calls at the rung ``precision`` (the reference's
    ``vmap`` of it when an operand has a batch axis)."""
    vals = list(first_ops)
    for cr, ci in link_ops:
        vals.extend((cr, ci))
    return _chain_compute(vals, links, precision)


# the chain kernel's table and block (csrc/fused_chain.cu: kHeader,
# kFields, kMaxStages, kMaxPtrs, kThreads, kFold)
_CHAIN_HEADER = 6
_CHAIN_FIELDS = 28
CHAIN_STAGES_PER_LAUNCH = 16
_CHAIN_MAX_PTRS = 2 * (CHAIN_STAGES_PER_LAUNCH + 5)
CHAIN_THREADS = 256
CHAIN_FOLD = 16
#: a global operand of at most this many elements, or the slow operand of a
#: stage with several outputs a thread, is fetched into shared memory at the
#: start of a resident launch, as far as the block's shared memory allows
CHAIN_PREFETCH_ELEMS = 4096
#: the chain kernel's two launch forms: one ordinary launch of one block a
#: batch row, the chain resident in shared memory; one cooperative launch of
#: a persistent grid, the carried value in L2 scratch
CHAIN_RESIDENT, CHAIN_GRID = "resident", "grid"
_FORM_CODE = {CHAIN_RESIDENT: 0, CHAIN_GRID: 1}

#: ``fused_chain`` launches of each form since the last :func:`reset_launches`
CHAIN_FORMS: dict[str, int] = {CHAIN_RESIDENT: 0, CHAIN_GRID: 0}


class ChainStageShape(NamedTuple):
    """How a block's threads cover one chain stage ``C (M, N) = Aᵀ B``
    over ``K``: ``slow_b`` says which operand is slow (``B`` when true):
    a thread owns ``tm`` consecutive outputs along its free index, while
    consecutive threads take consecutive outputs along the other (fast)
    operand's free index, ``tn`` of them a thread (strided, so a warp reads
    each coalesced); ``ks`` threads split the contract index of every
    output."""

    slow_b: bool
    tm: int
    ks: int
    tn: int = 1


def chain_stage_shape(k: int, m: int, n: int) -> ChainStageShape:
    """The thread shape of one ``(K, M, N)`` stage in the resident form: the
    larger free extent is fast. A stage of at most ``CHAIN_THREADS // 2``
    outputs splits K over as many threads as fill the block (a power of
    two, at most K); a larger one gives each thread up to 8 outputs along
    the slow index, as few as cover the outputs in one pass of the block.
    Where 8 are not enough and K is long, a thread takes 2 fast columns
    and 2 threads split K: the slow row each thread reads (the same for
    every lane of a warp, so the costliest read of the stage) then feeds
    twice the multiply-adds, and the block's threads stay busy.

    >>> chain_stage_shape(256, 8, 256)      # the head of a chain to a scalar
    ChainStageShape(slow_b=False, tm=8, ks=2, tn=2)
    >>> chain_stage_shape(2048, 1, 1)       # its link: a 2048-long dot
    ChainStageShape(slow_b=False, tm=1, ks=256, tn=1)
    >>> chain_stage_shape(4, 8, 4), chain_stage_shape(16, 200, 1)
    (ChainStageShape(slow_b=True, tm=1, ks=4, tn=1), ChainStageShape(slow_b=True, tm=1, ks=1, tn=1))
    >>> chain_stage_shape(16, 8, 256)       # too short a K to split
    ChainStageShape(slow_b=False, tm=8, ks=1, tn=1)
    """
    slow_b = m > n
    s, f = (n, m) if slow_b else (m, n)
    if m * n <= CHAIN_THREADS // 2:
        cap = min(k, CHAIN_THREADS // (m * n))
        ks = 1
        while 2 * ks <= cap:
            ks *= 2
        return ChainStageShape(slow_b, 1, ks)
    tm = 1
    while tm < 8 and 2 * tm <= s and -(-s // tm) * f > CHAIN_THREADS:
        tm *= 2
    if tm == 8 and -(-s // 8) * -(-f // 2) >= CHAIN_THREADS // 2 and k >= 4 * CHAIN_FOLD:
        return ChainStageShape(slow_b, 8, 2, 2)
    return ChainStageShape(slow_b, tm, 1)


def chain_k_blocks(k: int, ks: int, work: int, sms: int) -> int:
    """Blocks that split a grid-form stage's contract index: 1 when its
    ``work`` items (batch rows x tiles of outputs) fill ``sms`` SMs, else
    as many as fill them, keeping at least 8 contract indices a thread.

    >>> chain_k_blocks(65536, 256, 1, 132), chain_k_blocks(16, 1, 32, 132)
    (32, 2)
    >>> chain_k_blocks(2048, 1, 200, 132)
    1
    """
    if work >= sms:
        return 1
    return max(1, min(sms // work, k // (8 * ks)))


def _plane(n: int, itemsize: int) -> int:
    """Elements of one part of a shared-memory or scratch region, rounded up
    to whole 16-byte vectors."""
    vec = 16 // itemsize
    return -(-n // vec) * vec


class _ChainLaunch(NamedTuple):
    """One launch of a chain: its host table (and that table's address),
    where each of its pointers comes from (``(base, byte offset)``: base
    ``j`` is flat operand ``j``, the last base the call's one allocation),
    its form and its stages' thread shapes."""

    table: object
    table_addr: int
    recipe: tuple
    form: str
    shapes: tuple


class _ChainPlan:
    """The launches of one chain shape, planned once: built from a call's
    operands (which it validates), reused by every call whose operands
    have the same shapes, strides, dtype and device.

    Stage ``i`` computes ``(M_i, N_i)`` over ``K_i`` from operands that are
    either a call operand pair (flat pair ``p``: the head's two, then one
    per link), read through its strides and batch stride (0 for a 2-D
    operand, which every batch row reads), or the previous stage's result,
    regrouped by its link. Each stage gets its :func:`chain_stage_shape`.
    Stages run in launches of at most ``CHAIN_STAGES_PER_LAUNCH``; a launch
    whose carried values (``2 x M x N`` per value, two ping-pong buffers)
    fit one block's shared memory is resident, else grid (with
    :func:`chain_k_blocks` per stage). The call's one allocation holds the
    output's two planes, then scratch: the grid form's ping-pong pairs and
    K-split partials, and the value one launch hands the next.

    ``out_shape``: the shape of each returned part (default ``(rows,
    cols)``, after the batch when there is one); any shape of as many
    elements. ``sms``: SMs the grid form plans for; ``smem``: shared
    memory of one block, in bytes. ``precision``: the dot-precision rung
    every launch of the plan computes (``rung``; ``float32`` for float64
    operands), a launch argument of the kernel."""

    __slots__ = ("launches", "n_stages", "out_shape", "alloc_shape", "batch",
                 "dtype", "device", "stages", "rung")

    def __init__(self, first_ops, link_ops, links, out_shape=None,
                 sms: int = H100_SMS, smem: int = MAX_SMEM_BYTES, precision=None):
        if len(links) != len(link_ops):
            raise ValueError("links and link_ops must pair up")
        flat = list(first_ops) + [t for pair in link_ops for t in pair]
        _check_parts("fused_chain", flat)
        for j in range(0, len(flat), 2):
            _check_pair("fused_chain", flat[j], flat[j + 1])
        fr, _, sr, _ = first_ops
        if fr.shape[-2] != sr.shape[-2]:
            raise ValueError("fused_chain: head contract dims differ")
        self.batch = _batch_of("fused_chain", flat)
        self.dtype, self.device = fr.dtype, fr.device
        self.rung = _rung(precision, fr.dtype)
        isz = fr.element_size()
        rows = 1 if self.batch is None else self.batch

        def operand(pair, t):
            return ("op", pair, t.stride(-2), t.stride(-1), _batch_stride(t))

        # (a, b, K, M, N): an operand is ("op", pair, sk, sf, sb) or
        # ("carried", sk, sf), the previous stage's (M, N) result
        k0, m0 = fr.shape[-2:]
        stages = [(operand(0, fr), operand(1, sr), k0, m0, sr.shape[-1])]
        shape = (m0, sr.shape[-1])
        for i, ((cr, _), link) in enumerate(zip(link_ops, links)):
            r, c = link.carried_shape
            if r * c != shape[0] * shape[1]:
                raise ValueError(f"fused_chain: link {i} regroups {shape} to {(r, c)}")
            # the carried value is row-major (r, c); as a (K, F) operand it
            # has strides (c, 1) when k is axis 0, (1, c) when axis 1
            k, f = link.carried_shape[link.k_axis], link.carried_shape[1 - link.k_axis]
            kc, x = cr.shape[-2:]
            if kc != k:
                raise ValueError(f"fused_chain: link {i} contracts {k} against {kc}")
            carried = ("carried",) + ((c, 1) if link.k_axis == 0 else (1, c))
            if link.carried_first:
                stages.append((carried, operand(2 + i, cr), k, f, x))
            else:
                stages.append((operand(2 + i, cr), carried, k, x, f))
            shape = link.out_shape(x)
        n_out = rows * shape[0] * shape[1]
        if out_shape is None:
            out_shape = shape if self.batch is None else (self.batch,) + shape
        if math.prod(out_shape) != n_out:
            raise ValueError(f"fused_chain: out_shape {out_shape} for {n_out} elements")
        self.out_shape = tuple(out_shape)
        self.n_stages = len(stages)
        shapes = [chain_stage_shape(k, m, n) for _, _, k, m, n in stages]

        out_base = len(flat)  # the base of the call's allocation
        scratch = [2 * n_out]  # next free element of the allocation

        def region(n: int) -> tuple:
            """A (re, im) scratch pair of n elements a part: its recipe."""
            at, plane = scratch[0], _plane(n, isz)
            scratch[0] += 2 * plane
            return ((out_base, at * isz), (out_base, (at + plane) * isz))

        launches = []
        hand_in = None  # the scratch pair one launch hands the next
        for s0 in range(0, len(stages), CHAIN_STAGES_PER_LAUNCH):
            seg = stages[s0:s0 + CHAIN_STAGES_PER_LAUNCH]
            seg_shapes = shapes[s0:s0 + CHAIN_STAGES_PER_LAUNCH]
            last = s0 + len(seg) == len(stages)
            m, n = seg[-1][3:5]
            if last:
                hand_out = ((out_base, 0), (out_base, n_out * isz))
            else:
                hand_out = region(rows * m * n)
            launches.append(_plan_chain_launch(
                seg, seg_shapes, rows, isz, hand_in, hand_out, region, sms, smem))
            hand_in = hand_out
        self.launches = tuple(launches)
        #: each stage's thread shape, as its launch runs it
        self.stages = [sh for lc in self.launches for sh in lc.shapes]
        lead = -(-(scratch[0] - 2 * n_out) // max(n_out, 1))
        self.alloc_shape = (2 + lead,) + self.out_shape

    @property
    def forms(self) -> tuple[str, ...]:
        """The form of each launch."""
        return tuple(lc.form for lc in self.launches)

    def launch(self, flat):
        """Launch the chain on the flat operands (``first_ops`` then every
        link pair) of the shapes it was planned for; returns ``(re,
        im)``."""
        return self.launch_ptrs([t.data_ptr() for t in flat])

    def launch_ptrs(self, bases):
        """:meth:`launch` given each flat operand's address (its
        ``data_ptr()``); the operands must stay alive until the launch is
        queued, which it is on return."""
        import torch

        if self.device.index != torch.cuda.current_device():
            with torch.cuda.device(self.device):
                return self._launch(bases)
        return self._launch(bases)

    def _launch(self, bases):
        import torch

        buf = torch.empty(self.alloc_shape, dtype=self.dtype, device=self.device)
        bases = list(bases)
        bases.append(buf.data_ptr())
        lib = _LIBS.get("fused_chain") or _library("fused_chain")
        stream = _raw_stream(self.device)
        single = self.dtype == torch.float32
        for lc in self.launches:
            ptrs = array("Q", [bases[b] + off for b, off in lc.recipe])
            if single:
                rc = lib.tnc_fused_chain_f32(ptrs.buffer_info()[0], len(lc.recipe),
                                             lc.table_addr, RUNG_CODES[self.rung], stream)
            else:
                rc = lib.tnc_fused_chain_f64(ptrs.buffer_info()[0], len(lc.recipe),
                                             lc.table_addr, stream)
            _check(lib, rc, "fused_chain")
            _count("fused_chain", self.rung)
            CHAIN_FORMS[lc.form] += 1
        return buf[0], buf[1]


def _plan_chain_launch(seg, shapes, rows, isz, hand_in, hand_out, region, sms, smem):
    """The table of one launch of stages ``seg`` (their thread
    :class:`ChainStageShape` s ``shapes``): ``hand_in`` is the recipe of the
    scratch pair holding the carried value a previous launch left (``None``
    for the first), ``hand_out`` where the last stage writes;
    ``region(n)`` reserves a scratch pair of the call's allocation."""
    import numpy as np

    recipe: list = []
    slots: dict = {}

    def slot(key, rec) -> int:
        if key not in slots:
            slots[key] = len(recipe) // 2
            recipe.extend(rec)
        return slots[key]

    def op_slot(pair) -> int:
        return slot(("op", pair), ((2 * pair, 0), (2 * pair + 1, 0)))

    # the carried values this launch keeps: stage i's result, i < last
    carried = [m * n for _, _, _, m, n in seg[:-1]]
    bufs = [max(carried[j::2], default=0) for j in (0, 1)]
    # the reduction buffer: 2 planes of every split output of a thread
    red = 2 * CHAIN_THREADS * max([sh.tm * sh.tn for sh in shapes if sh.ks > 1], default=0)
    resident_elems = sum(2 * _plane(b, isz) for b in bufs) + red
    form = CHAIN_RESIDENT if resident_elems * isz <= smem else CHAIN_GRID
    if form == CHAIN_GRID:
        # the grid form's blocks keep one reduction buffer of 2 values a
        # thread: a stage splits K within a block only at one output a thread
        shapes = [sh._replace(ks=1, tn=1) if sh.tn > 1 else sh for sh in shapes]
    if form == CHAIN_RESIDENT:
        # shared memory: the two carried buffers, the fetched operands, the
        # reduction buffer
        offs = []
        at = 0
        for b in bufs:
            offs.append((at, at + _plane(b, isz)))
            at += 2 * _plane(b, isz)
        room = smem // isz - at - red
    else:
        pp = [region(rows * b) if b else None for b in bufs]
        parts = 0  # elements a part of the K-split partials
    rows_out = []
    grid = rows
    for i, ((a, b, k, m, n), sh) in enumerate(zip(seg, shapes)):
        s_extent = n if sh.slow_b else m
        kb = 1
        if form == CHAIN_GRID:
            groups = -(-s_extent // sh.tm) * -(-(m if sh.slow_b else n) // sh.tn)
            tiles = -(-groups // (CHAIN_THREADS // sh.ks))
            kb = chain_k_blocks(k, sh.ks, rows * tiles, sms)
            grid = max(grid, rows * tiles * kb)
        views = []
        for side, (src, free) in enumerate(((a, m), (b, n))):
            slow = side == int(sh.slow_b)
            if src[0] == "op":
                _, pair, sk, sf, sb = src
                view = [op_slot(pair), sk, sf, sb, -1, -1]
                elems = k * free
                if form == CHAIN_RESIDENT and (
                        elems <= CHAIN_PREFETCH_ELEMS or (slow and sh.tm > 1)) \
                        and 2 * _plane(elems, isz) <= room:
                    view[4:6] = [at, at + _plane(elems, isz)]
                    at += 2 * _plane(elems, isz)
                    room -= 2 * _plane(elems, isz)
                    sk, sf = free, 1
            else:
                _, sk, sf = src
                if i == 0:  # left in scratch by the previous launch
                    view = [slot(("in",), hand_in), sk, sf, k * free, -1, -1]
                elif form == CHAIN_RESIDENT:
                    view = [-1, sk, sf, 0, *offs[(i - 1) % 2]]
                else:
                    view = [slot(("pp", (i - 1) % 2), pp[(i - 1) % 2]), sk, sf, k * free,
                            -1, -1]
            views.append((view, sk, sf, slow))
        slow_view, s_sk, s_sf = next((v, sk, sf) for v, sk, sf, slow in views if slow)
        use_vec = (form == CHAIN_RESIDENT and sh.tm > 1 and slow_view[4] >= 0
                   and s_sf == 1 and s_sk == s_extent and s_extent % sh.tm == 0)
        if i == len(seg) - 1:
            c = [slot(("out",), hand_out), n, 1, m * n, -1, -1]
        elif form == CHAIN_RESIDENT:
            c = [-1, n, 1, 0, *offs[i % 2]]
        else:
            c = [slot(("pp", i % 2), pp[i % 2]), n, 1, m * n, -1, -1]
        part = -1
        if kb > 1:
            parts = max(parts, kb * rows * m * n)
            part = -2  # set below, once the partials' size is known
        rows_out.append(views[0][0] + views[1][0] + c
                        + [k, m, n, int(sh.slow_b), sh.tm, sh.ks, kb, int(use_vec), part,
                           sh.tn])
    if form == CHAIN_GRID and parts:
        part_slot = slot(("part",), region(parts))
        for r in rows_out:
            if r[-2] == -2:
                r[-2] = part_slot
    if form == CHAIN_RESIDENT:
        smem_bytes, red_off, grid = (at + red) * isz, at, rows
    else:
        smem_bytes, red_off = 2 * CHAIN_THREADS * isz, 0
    header = [_FORM_CODE[form], len(seg), rows, grid, smem_bytes, red_off]
    table = np.ascontiguousarray(header + [v for r in rows_out for v in r], dtype=np.int64)
    if len(recipe) > _CHAIN_MAX_PTRS:
        raise ValueError(f"fused_chain: a launch needs {len(recipe)} pointers")
    return _ChainLaunch(table, table.ctypes.data, tuple(recipe), form, tuple(shapes))


def chain_plan(first_ops, link_ops, links, out_shape=None, precision=None) -> _ChainPlan:
    """The validated plan of a chain on these operands at the rung
    ``precision`` (see :class:`_ChainPlan`), for the card the operands lie
    on: build it once per chain shape and rung and pass it to every
    :func:`fused_chain` call."""
    dev = first_ops[0].device
    sms = _sm_count(dev) if dev.type == "cuda" else H100_SMS
    return _ChainPlan(first_ops, link_ops, links, out_shape, sms=sms, precision=precision)


def fused_chain(first_ops, link_ops, links, plan: _ChainPlan | None = None,
                precision=None):
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

    ``plan``: the chain's :func:`chain_plan`, built once by the caller for
    operands of these shapes, strides, dtype and device (not checked
    again); without it the call plans (and validates) anew. ``precision``:
    the dot-precision rung (``float32`` / ``None``, ``high``, ``default``;
    a given plan must have been planned at it).

    CPU tensors run :func:`fused_chain_reference` at that rung. CUDA
    tensors launch the chain kernel once, in the plan's form (a chain of
    more than ``CHAIN_STAGES_PER_LAUNCH`` stages takes one launch per that
    many), at the plan's rung.
    """
    if plan is None:
        plan = chain_plan(first_ops, link_ops, links, precision=precision)
    elif plan.rung != _rung(precision, plan.dtype):
        raise ValueError(f"fused_chain: a plan at rung {plan.rung} called at "
                         f"{_rung(precision, plan.dtype)}")
    if first_ops[0].device.type == "cpu":
        return fused_chain_reference(first_ops, link_ops, links, plan.rung)
    return plan.launch(list(first_ops) + [t for pair in link_ops for t in pair])


def empty_chain_launch(cooperative: bool, grid: int) -> None:
    """One launch of an empty kernel of the chain kernel's block size on
    ``grid`` blocks, ordinary or cooperative, on the current stream: the
    floor under a launch of each chain form (not counted in
    :data:`LAUNCHES`)."""
    import torch

    lib = _library("fused_chain")
    rc = lib.tnc_chain_empty_launch(int(cooperative), int(grid),
                                    _stream(torch.device("cuda")))
    _check(lib, rc, "empty chain")
