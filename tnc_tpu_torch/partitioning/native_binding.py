"""ctypes binding to the native C++ planner engines (the port's copy of
``tnc_tpu.partitioning.native_binding``).

Three sources under ``native/`` (byte-for-byte the reference's): the
multilevel partitioner (``partitioner.cpp``), the exact subset DP of tree
reconfiguration (``treedp.cpp``) and the sliced-path replay
(``slicereplay.cpp``). They are compiled into one shared library with
``g++ -O3 -march=native -std=c++17 -shared -fPIC`` (retried without
``-march=native``) at first use and loaded with ctypes.

The build differs from the reference's in where it goes and when it is
redone: the library is written to ``_build/`` beside this module (listed
in ``.gitignore``), named by a hash of the sources, the flags and the
compiler's target macros, so a stale or foreign build is never loaded and
no tracked file is ever written. Nothing is rebuilt by file times.

Where no compiler is found, or ``TNC_TPU_NO_NATIVE=1`` is set as in the
reference, every caller runs its pure-Python path (the engines' oracle).
:data:`NATIVE` says which one ran.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import subprocess
import sys
import tempfile
import threading
from pathlib import Path

from tnc_tpu_torch.partitioning.hypergraph import Hypergraph

_NATIVE_DIR = Path(__file__).resolve().parent / "native"
_BUILD_DIR = Path(__file__).resolve().parent / "_build"
_SOURCES = [
    _NATIVE_DIR / "partitioner.cpp",
    _NATIVE_DIR / "treedp.cpp",
    _NATIVE_DIR / "slicereplay.cpp",
]
_FLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC"]

#: what the last :func:`load_native` call answered: ``"unloaded"`` before
#: the first, then ``"native"`` (the library's path in :data:`NATIVE_PATH`)
#: or ``"python: <reason>"`` (the callers then run their Python engines)
NATIVE = "unloaded"
NATIVE_PATH: Path | None = None

_lib: ctypes.CDLL | None = None
_load_failed: str | None = None  # why the library could not be loaded
_LOCK = threading.Lock()


def _target(compiler: str) -> tuple[list[str], bytes]:
    """The flags to build with — the reference's, without
    ``-march=native`` where the compiler refuses it — and the compiler's
    target macros under them."""
    probe = [compiler, "-dM", "-E", "-x", "c++", os.devnull]
    native = subprocess.run([*probe, "-march=native"], capture_output=True, timeout=60)
    if native.returncode == 0:
        return list(_FLAGS), native.stdout
    plain = subprocess.run(probe, capture_output=True, timeout=60)
    return [f for f in _FLAGS if f != "-march=native"], plain.stdout


def _library_path(compiler: str, flags: list[str], macros: bytes) -> Path:
    """The library for the current sources, flags and compiler target.

    The target macros key the name because ``-march=native`` makes the
    code, and its floating-point contraction, depend on the host CPU."""
    h = hashlib.sha256()
    for src in _SOURCES:
        h.update(src.read_bytes())
    h.update(" ".join([compiler, *flags]).encode())
    h.update(macros)
    return _BUILD_DIR / f"_partitioner-{h.hexdigest()[:16]}.so"


def _build_library(compiler: str, flags: list[str], out: Path) -> str | None:
    """Compile the library to ``out``; the failure's reason, or None."""
    out.parent.mkdir(parents=True, exist_ok=True)
    # atomic replace: concurrent test workers never load a half-written .so
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=str(out.parent))
    os.close(fd)
    cmd = [compiler, *flags, *[str(s) for s in _SOURCES], "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, timeout=240)
        if proc.returncode != 0:
            os.unlink(tmp)
            err = proc.stderr.decode(errors="replace")[-2000:]
            print(f"tnc_tpu_torch: native planner build failed:\n{err}",
                  file=sys.stderr)
            return f"build failed ({compiler} exited {proc.returncode})"
        os.replace(tmp, out)
        return None
    except (OSError, subprocess.TimeoutExpired) as exc:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return f"build failed ({type(exc).__name__})"


def load_native() -> ctypes.CDLL | None:
    """The loaded library, building it if needed; None when unavailable.
    Sets :data:`NATIVE` to what this call answered."""
    global NATIVE
    if os.environ.get("TNC_TPU_NO_NATIVE"):
        NATIVE = "python: TNC_TPU_NO_NATIVE is set"
        return None
    if _lib is None and _load_failed is None:
        with _LOCK:
            if _lib is None and _load_failed is None:
                _load()
    NATIVE = "native" if _lib is not None else f"python: {_load_failed}"
    return _lib


def _load() -> None:
    """Build (where needed) and load the library, or record why not."""
    global _lib, _load_failed, NATIVE_PATH
    try:
        compiler = os.environ.get("CXX", "g++")
        flags, macros = _target(compiler)
        path = _library_path(compiler, flags, macros)
        if not path.exists():
            reason = _build_library(compiler, flags, path)
            if reason is not None:
                _load_failed = reason
                return
        lib = ctypes.CDLL(str(path))
    except (OSError, subprocess.TimeoutExpired) as exc:
        _load_failed = f"no native library ({type(exc).__name__}: {exc})"
        return
    _declare(lib)
    _lib = lib
    NATIVE_PATH = path


def _declare(lib: ctypes.CDLL) -> None:
    """The C entry points' signatures."""
    i32p = ctypes.POINTER(ctypes.c_int)
    f64p = ctypes.POINTER(ctypes.c_double)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    c_int, c_double = ctypes.c_int, ctypes.c_double
    signatures = {
        "tnc_partition_kway": (c_int, [c_int, f64p, c_int, i32p, i32p, f64p,
                                       c_int, c_double, ctypes.c_uint64, i32p]),
        "tnc_cut_weight": (c_double, [c_int, c_int, i32p, i32p, f64p, i32p]),
        "tnc_kway_refine_km1": (c_int, [c_int, f64p, c_int, i32p, i32p, f64p,
                                        c_int, c_double, c_int, i32p]),
        "tnc_km1_weight": (c_double, [c_int, c_int, i32p, i32p, f64p, c_int,
                                      i32p]),
        "tnc_sliced_replay": (c_int, [c_int, c_int, u64p, f64p, c_int, i32p,
                                      u64p, f64p, f64p, f64p]),
        "tnc_optimal_order": (c_int, [c_int, c_int, u64p, f64p, c_int,
                                      c_double, f64p, i32p]),
    }
    for name, (restype, argtypes) in signatures.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes


def native_partition_kway(
    hg: Hypergraph, k: int, imbalance: float, seed: int, trials: int = 4
) -> list[int] | None:
    """k-way partition via the C++ library; None when native is off.

    Runs ``trials`` seeded multi-starts and keeps the best cut (the
    native solver is ~12x faster per run than the Python fallback, so
    multi-start is still a large net win in both time and quality).
    """
    import numpy as np

    lib = load_native()
    if lib is None:
        return None
    n = hg.num_vertices
    m = len(hg.edge_pins)
    offsets, pins, vw, ew = _csr_arrays(hg)
    out = np.empty(n, dtype=np.int32)

    as_i32 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))  # noqa: E731
    as_f64 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))  # noqa: E731

    best: "np.ndarray | None" = None
    best_cut = float("inf")
    for t in range(max(1, trials)):
        rc = lib.tnc_partition_kway(
            n, as_f64(vw), m, as_i32(offsets), as_i32(pins), as_f64(ew),
            k, ctypes.c_double(imbalance),
            ctypes.c_uint64((seed + 0x9E3779B97F4A7C15 * t) & (2**64 - 1)),
            as_i32(out),
        )
        if rc != 0:
            return None
        cut = lib.tnc_cut_weight(n, m, as_i32(offsets), as_i32(pins), as_f64(ew), as_i32(out))
        if cut < best_cut:
            best_cut = cut
            best = out.copy()
        out = np.empty(n, dtype=np.int32)
    assert best is not None
    return best.tolist()


def _csr_arrays(hg: Hypergraph):
    import numpy as np

    m = len(hg.edge_pins)
    offsets = np.zeros(m + 1, dtype=np.int32)
    lengths = np.fromiter(
        (len(e) for e in hg.edge_pins), dtype=np.int32, count=m
    )
    np.cumsum(lengths, out=offsets[1:])
    pins = np.fromiter(
        (v for e in hg.edge_pins for v in e),
        dtype=np.int32,
        count=int(offsets[-1]),
    )
    vw = np.asarray(hg.vertex_weights, dtype=np.float64)
    ew = np.asarray(hg.edge_weights, dtype=np.float64)
    return offsets, pins, vw, ew


def native_kway_refine_km1(
    hg: Hypergraph,
    part: "list[int]",
    k: int,
    imbalance: float,
    max_passes: int = 8,
) -> list[int] | None:
    """km1 (connectivity) k-way refinement via the C++ library; returns
    the refined partition, or None when native is off."""
    import numpy as np

    lib = load_native()
    if lib is None:
        return None
    offsets, pins, vw, ew = _csr_arrays(hg)
    buf = np.asarray(part, dtype=np.int32).copy()
    as_i32 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))  # noqa: E731
    as_f64 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))  # noqa: E731
    rc = lib.tnc_kway_refine_km1(
        hg.num_vertices, as_f64(vw), len(hg.edge_pins), as_i32(offsets),
        as_i32(pins), as_f64(ew), k, ctypes.c_double(imbalance),
        int(max_passes), as_i32(buf),
    )
    if rc != 0:
        return None
    return buf.tolist()


def native_km1_weight(
    hg: Hypergraph, part: "list[int]", k: int
) -> float | None:
    """km1 (connectivity) metric via the C++ library; None when native
    is off or the partition is invalid (values outside 0..k)."""
    import numpy as np

    lib = load_native()
    if lib is None:
        return None
    offsets, pins, _vw, ew = _csr_arrays(hg)
    buf = np.asarray(part, dtype=np.int32)
    as_i32 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))  # noqa: E731
    as_f64 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))  # noqa: E731
    out = float(
        lib.tnc_km1_weight(
            hg.num_vertices, len(hg.edge_pins), as_i32(offsets), as_i32(pins),
            as_f64(ew), k, as_i32(buf),
        )
    )
    return None if out < 0 else out


class SlicedReplayer:
    """Reusable native replayer over one (inputs, path) pair.

    Precomputes bitmask leg sets and the dense leg index once; each
    ``sizes``/``flops`` call replays the path with a different removed
    set in C++ (``native/slicereplay.cpp``) — the planner's hottest loop
    (slicing-aware candidate scoring calls it thousands of times per
    plan; ~96% of north-star planning time in Python).
    ``available`` is False when the native library is off — callers keep
    their Python loops as oracle/fallback.
    """

    def __init__(self, inputs, replace_path):
        import numpy as np

        self._lib = load_native()
        # degenerate instances (no leaves / empty path) stay on the
        # Python oracle, which defines their behavior (peak 0.0)
        self.available = (
            self._lib is not None
            and len(inputs) > 0
            and len(replace_path) > 0
        )
        if not self.available:
            return
        legs = sorted({leg for t in inputs for leg in t.legs})
        self._leg_index = {leg: i for i, leg in enumerate(legs)}
        self._legs = legs
        n_words = max(1, (len(legs) + 63) // 64)
        self._n_words = n_words
        self._masks = np.zeros((len(inputs), n_words), dtype=np.uint64)
        self._log2dims = np.zeros(n_words * 64, dtype=np.float64)
        for t_i, t in enumerate(inputs):
            for leg, dim in t.edges():
                i = self._leg_index[leg]
                self._masks[t_i, i // 64] |= np.uint64(1 << (i % 64))
                self._log2dims[i] = float(np.log2(max(1, dim)))
        self._pairs = np.asarray(replace_path, dtype=np.int32).reshape(-1)
        self._n_leaves = len(inputs)
        self._n_steps = len(replace_path)

    def _removed_mask(self, removed):
        import numpy as np

        mask = np.zeros(self._n_words, dtype=np.uint64)
        for leg in removed:
            i = self._leg_index.get(leg)
            if i is not None:
                mask[i // 64] |= np.uint64(1 << (i % 64))
        return mask

    def _call(self, removed, want_leg_peak: bool):
        import numpy as np

        as_u64 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))  # noqa: E731
        as_f64 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))  # noqa: E731
        as_i32 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))  # noqa: E731
        rm = self._removed_mask(removed)
        peak = ctypes.c_double(0.0)
        flops = ctypes.c_double(0.0)
        leg_peak = (
            np.zeros(self._n_words * 64, dtype=np.float64)
            if want_leg_peak
            else None
        )
        rc = self._lib.tnc_sliced_replay(
            self._n_leaves,
            self._n_words,
            as_u64(self._masks),
            as_f64(self._log2dims),
            self._n_steps,
            as_i32(self._pairs),
            as_u64(rm),
            ctypes.byref(peak),
            ctypes.byref(flops),
            as_f64(leg_peak) if leg_peak is not None else None,
        )
        if rc != 0:
            raise ValueError("tnc_sliced_replay rejected the path")
        return float(peak.value), float(flops.value), leg_peak

    def sizes(self, removed) -> tuple[float, dict[int, float]]:
        """(peak step size, leg -> largest participating step size) —
        the native ``_replay_sizes``."""
        peak, _flops, leg_peak = self._call(removed, want_leg_peak=True)
        out = {
            self._legs[i]: float(v)
            for i, v in enumerate(leg_peak[: len(self._legs)])
            if v > 0.0
        }
        return peak, out

    def flops(self, removed) -> float:
        """Total union-size op cost — the native ``_reduced_flops``."""
        _peak, flops, _ = self._call(removed, want_leg_peak=False)
        return flops

    def peak_and_flops(self, removed) -> tuple[float, float]:
        """Both metrics from a single replay (candidate-leg scoring
        needs both; one native call instead of two)."""
        peak, flops, _ = self._call(removed, want_leg_peak=False)
        return peak, flops

    def peak(self, removed) -> float:
        """Peak step size only (acceptance checks)."""
        peak, _flops, _ = self._call(removed, want_leg_peak=False)
        return peak


def native_optimal_order(
    leg_sets: "list[frozenset[int]]",
    dims: "dict[int, int]",
    minimize: str = "flops",
    logsize_cap: float = -1.0,
) -> tuple[float, list[tuple[int, int]]] | None:
    """Exact subset-DP ordering over ``leg_sets`` via the C++ kernel.

    Native engine of ``ContractionTree.reconfigure``; returns
    (cost, local ssa pairs) like the Python ``_optimal_order``;
    ``(inf, [])`` when the DP *proved* no ordering satisfies
    ``logsize_cap`` (callers must not fall back to the Python DP — it
    would only reproduce the proof slowly); None when native is
    unavailable or n is out of range.
    """
    import numpy as np

    lib = load_native()
    n = len(leg_sets)
    if lib is None or not 2 <= n <= 16:
        return None
    all_legs = sorted(set().union(*leg_sets))
    index = {leg: i for i, leg in enumerate(all_legs)}
    nlegs = len(all_legs)
    nwords = max(1, (nlegs + 63) // 64)
    masks = np.zeros((n, nwords), dtype=np.uint64)
    for i, legs in enumerate(leg_sets):
        for leg in legs:
            j = index[leg]
            masks[i, j // 64] |= np.uint64(1 << (j % 64))
    logdims = np.array(
        [math.log2(max(1, dims[leg])) for leg in all_legs], dtype=np.float64
    )
    out_cost = ctypes.c_double(0.0)
    out_pairs = np.empty(2 * (n - 1), dtype=np.int32)
    rc = lib.tnc_optimal_order(
        n,
        nlegs,
        masks.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        logdims.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        0 if minimize == "flops" else 1,
        ctypes.c_double(logsize_cap),
        ctypes.byref(out_cost),
        out_pairs.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
    )
    if rc == 1:
        return math.inf, []
    if rc != 0:
        return None
    pairs = [
        (int(out_pairs[2 * k]), int(out_pairs[2 * k + 1])) for k in range(n - 1)
    ]
    return float(out_cost.value), pairs
