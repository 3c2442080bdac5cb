"""The port's fused transpose-dot rung against the JAX package's, on the CPU.

- Gate parity: for every step of seven plans (random circuits of 12, 20
  and 28 qubits; four PEPS networks), the port's gate gives the
  reference's reason, layouts and tiles.
- The plain version (what the wrapper runs on CPU tensors) against
  ``fused_transpose_dot_kl`` in Pallas interpret mode, on the reference
  test's randomized layouts and on the admitted steps of
  ``peps(3, 3, 2, 16, 0)``.
- The forced ``fused_transpose`` rung end to end on two PEPS norms,
  against the reference's forced rung and the complex128 oracle, with
  the kernel route taken exactly as often as the reference takes it.
- The PEPS builder and ``attach_random_data`` against the reference's.

Tolerances: a single product within 1e-5·max|ref| (float32 products
summed in another order); a whole PEPS norm within 1e-4 relative (the
naive rung and the reference's forced rung were measured within 1.6e-5
of each other on these networks).
"""

import importlib
import math
import re

import jax
import numpy as np
import pytest
import torch

import tnc_tpu.ops.pallas_complex as ref_pc
import tnc_tpu.ops.split_complex as ref_sc
from tnc_tpu import obs
from tnc_tpu.builders.connectivity import ConnectivityLayout
from tnc_tpu.builders.peps import peps as ref_peps
from tnc_tpu.contractionpath.paths import Greedy, OptMethod
from tnc_tpu.ops.backends import JaxBackend
from tnc_tpu.ops.program import build_program, flat_leaf_tensors
from tnc_tpu.tensornetwork.approximate import attach_random_data as ref_attach
from tnc_tpu_torch.builders.peps import peps as port_peps
from tnc_tpu_torch.contractionpath.paths import Greedy as PortGreedy
from tnc_tpu_torch.contractionpath.paths import OptMethod as PortOptMethod
from tnc_tpu_torch.interop import network_from_arrays, path_from_pairs
from tnc_tpu_torch.ops import cuda_complex as cc
from tnc_tpu_torch.ops import program as port_prog
from tnc_tpu_torch.ops import split_complex as port_sc
from tnc_tpu_torch.ops.backends import NumpyBackend, TorchBackend
from tnc_tpu_torch.tensornetwork.approximate import attach_random_data, unit_scale
from tnc_tpu_torch.tensornetwork.contraction import contract_tensor_network

ref_rc = importlib.import_module("tnc_tpu.builders.random_circuit")

PEPS_ARGS = [(3, 3, 2, 16, 0), (3, 4, 2, 16, 0), (4, 4, 2, 32, 0), (3, 4, 2, 32, 1)]


def _rel_err(got, want) -> float:
    got = [np.asarray(g, dtype=np.float64) for g in got]
    want = [np.asarray(w, dtype=np.float64) for w in want]
    for g, w in zip(got, want):
        assert g.shape == w.shape
    scale = max(float(np.max(np.abs(w))) for w in want)
    return max(float(np.max(np.abs(g - w))) for g, w in zip(got, want)) / scale


def _circuit_programs(qubits):
    """The slice-1 recipe (depth 12, Sycamore, p1 = p2 = 0.4, seed 42,
    open statevector): the reference's program and the port's, compiled
    from the same leaves and path."""
    tn = ref_rc.random_circuit(
        qubits, 12, 0.4, 0.4, np.random.default_rng(42),
        ConnectivityLayout.SYCAMORE, bitstring="*" * qubits,
    )
    path = Greedy(OptMethod.GREEDY).find_path(tn).replace_path()
    leaves = [(l.legs, l.bond_dims, l.data.into_data()) for l in flat_leaf_tensors(tn)]
    port = port_prog.build_program(
        network_from_arrays(leaves), path_from_pairs(path.toplevel)
    )
    return build_program(tn, path), port


def _peps_programs(args):
    """Each package builds, plans and compiles the metadata-only network
    on its own."""
    ref_tn, port_tn = ref_peps(*args), port_peps(*args)
    ref_path = Greedy(OptMethod.GREEDY).find_path(ref_tn).replace_path()
    port_path = PortGreedy(PortOptMethod.GREEDY).find_path(port_tn).replace_path()
    assert port_path.toplevel == ref_path.toplevel
    return (build_program(ref_tn, ref_path),
            port_prog.build_program(port_tn, port_path))


def _lay_key(lay):
    return None if lay is None else (lay.view, lay.k_axes, lay.f_axes)


@pytest.mark.parametrize(
    "plan", [("circuit", 12), ("circuit", 20), ("circuit", 28)]
    + [("peps", a) for a in PEPS_ARGS],
    ids=lambda p: f"{p[0]}{p[1]}",
)
def test_gate_parity_on_every_step(plan):
    """Reason, resolved mode, operand layouts and TPU tiles of every step
    equal the reference's."""
    kind, arg = plan
    ref_program, port_program = (
        _circuit_programs(arg) if kind == "circuit" else _peps_programs(arg)
    )
    assert len(port_program.steps) == len(ref_program.steps)
    admitted = 0
    for ref_st, port_st in zip(ref_program.steps, port_program.steps):
        reason = port_sc.fused_transpose_ineligible_reason(port_st)
        assert reason == ref_sc.fused_transpose_ineligible_reason(ref_st)
        assert port_sc.resolved_step_mode(port_st, "fused_transpose") == (
            ref_sc.resolved_step_mode(ref_st, "fused_transpose")
        )
        ref_lays = ref_sc._fused_transpose_layouts(ref_st)
        port_lays = port_sc._fused_transpose_layouts(port_st)
        assert [_lay_key(l) for l in port_lays] == [_lay_key(l) for l in ref_lays]
        if None not in port_lays:
            assert cc._plan_transpose_tiles(*port_lays) == (
                ref_pc._plan_transpose_tiles(*ref_lays)
            )
        admitted += reason is None
    if kind == "circuit":
        assert admitted == 0  # the gate admits no random-circuit step
    if arg == (4, 4, 2, 32, 0):
        assert admitted == 10


def _rand(shape, rng):
    return rng.standard_normal(shape).astype(np.float32)


def _plain_vs_pallas(a_shape, a_lay_ref, b_shape, b_lay_ref, rng):
    """The port's wrapper on CPU tensors (its plain version) against the
    Pallas kernel in interpret mode, same inputs."""
    ar, ai = _rand(a_shape, rng), _rand(a_shape, rng)
    br, bi = _rand(b_shape, rng), _rand(b_shape, rng)
    a_lay = cc.OperandLayout(*_lay_key(a_lay_ref))
    b_lay = cc.OperandLayout(*_lay_key(b_lay_ref))
    got = cc.fused_transpose_dot(
        *(torch.from_numpy(x) for x in (ar, ai, br, bi)), a_lay, b_lay
    )
    want = jax.jit(
        lambda a, b, c, d: ref_pc.fused_transpose_dot_kl(
            a, b, c, d, a_lay_ref, b_lay_ref, interpret=True
        )
    )(ar, ai, br, bi)
    assert _rel_err([g.numpy() for g in got], want) <= 1e-5


@pytest.mark.parametrize("seed", range(4))
def test_plain_version_vs_pallas_randomized_layouts(seed):
    """The reference test's randomized eligible layouts (identity kl/lk,
    rank-3 macro transposes on either side)."""
    rng = np.random.default_rng(100 + seed)

    def pick_layout():
        kind = rng.integers(0, 3)
        if kind == 0:
            k, f = 256, int(rng.choice([256, 384, 512]))
            return (k, f), ref_pc.operand_layout((k, f), None, (k, f), True)
        if kind == 1:
            k, f = 256, int(rng.choice([256, 512]))
            return (f, k), ref_pc.operand_layout((f, k), None, (f, k), False)
        x, y = 4, 64
        f = int(rng.choice([256, 512]))
        view = (x, f, y)
        return view, ref_pc.operand_layout(view, (0, 2, 1), (256, f), True)

    a_shape, a_lay = pick_layout()
    b_shape, b_lay = pick_layout()
    _plain_vs_pallas(a_shape, a_lay, b_shape, b_lay, rng)


def test_plain_version_vs_pallas_on_admitted_peps_steps():
    """The two steps of ``peps(3, 3, 2, 16, 0)`` the gate admits, through
    the port's step glue's own layouts."""
    ref_program, port_program = _peps_programs((3, 3, 2, 16, 0))
    rng = np.random.default_rng(7)
    admitted = [
        (r, p) for r, p in zip(ref_program.steps, port_program.steps)
        if port_sc.fused_transpose_step_eligible(p)
    ]
    assert len(admitted) == 2
    for ref_st, port_st in admitted:
        first, second = ref_sc._fused_transpose_layouts(ref_st)
        assert [_lay_key(l) for l in port_sc._fused_transpose_layouts(port_st)] == [
            _lay_key(first), _lay_key(second)
        ]
        _plain_vs_pallas(first.view, first, second.view, second, rng)


@pytest.mark.parametrize(
    "view,k_axes,f_axes,base_perm",
    [
        ((2, 32, 32, 8, 32), (1, 3), (0, 2, 4), None),  # steps 11/15 layout
        ((64, 32, 37, 8), (1, 3), (0, 2), None),
        ((3, 5, 7), (2, 0), (1,), None),  # contract digits out of stored order
        ((2, 4, 8), (1,), (0, 2), (2, 0, 1)),  # a strided stored view
    ],
)
def test_kernel_offset_tables_address_the_logical_matrix(view, k_axes, f_axes, base_perm):
    """What the CUDA kernel reads: element (k, f) of the logical (K, F)
    matrix at storage offset off_k[k] + off_f[f] of the wrapper's tables —
    held here against the plain view + permute + reshape."""
    lay = cc.OperandLayout(view, k_axes, f_axes)
    if base_perm is None:
        base = torch.randn(view, generator=torch.Generator().manual_seed(3))
        t = base
    else:
        base = torch.randn(tuple(view[i] for i in base_perm),
                           generator=torch.Generator().manual_seed(3))
        t = base.permute(*np.argsort(base_perm).tolist())
        assert tuple(t.shape) == view and not t.is_contiguous()
    off_k, off_f = cc._gather_tables(t, lay)
    assert off_k.shape == (lay.k_size,) and off_f.shape == (lay.f_size,)
    gathered = base.reshape(-1)[off_k[:, None] + off_f[None, :]]
    assert torch.equal(gathered, cc._as_kf(t, lay))


@pytest.mark.parametrize(
    "k_axes,f_axes", [((1,), (0,)), ((1, 2), (0, 2)), ((3,), (0, 1, 2))]
)
def test_wrapper_rejects_a_layout_that_does_not_split_the_axes(k_axes, f_axes):
    """A layout whose contract and free axes do not partition the stored
    axes would send the kernel's offset tables outside the operand: the
    wrapper refuses it before any launch."""
    t = torch.zeros(2, 3, 4)
    lay = cc.OperandLayout((2, 3, 4), k_axes, f_axes)
    with pytest.raises(ValueError, match="do not partition"):
        cc.fused_transpose_dot(t, t, t, t, lay, lay)


def _ref_routed(counters) -> dict[str, int]:
    out = {}
    for key, value in counters.items():
        m = re.fullmatch(r"ops\.fused_transpose_fallback\{reason=(\w+)\}", key)
        if m:
            out[m.group(1)] = int(value)
    return out


@pytest.mark.parametrize("args", [(3, 3, 2, 16, 0), (3, 4, 2, 16, 0)])
def test_forced_rung_end_to_end(args, monkeypatch):
    """``TNC_TPU_COMPLEX_MULT=fused_transpose`` on a PEPS norm at the O(1)
    scale: the port's scalar against the reference's forced rung and the
    complex128 oracle; the port takes the kernel route (its plain version
    here) as often as the reference calls its kernel, and routes the
    other steps for the same reasons."""
    monkeypatch.setenv("TNC_TPU_COMPLEX_MULT", "fused_transpose")
    tn = port_peps(*args)
    scale = unit_scale(tn)
    attach_random_data(tn, np.random.default_rng(42), scale=scale)
    ref_tn = ref_attach(ref_peps(*args), np.random.default_rng(42), scale=scale)
    path = PortGreedy(PortOptMethod.GREEDY).find_path(tn).replace_path()
    ref_path = Greedy(OptMethod.GREEDY).find_path(ref_tn).replace_path()

    port_calls, ref_calls = [], []
    plain, kernel = cc.fused_transpose_reference, ref_pc.fused_transpose_dot_kl
    monkeypatch.setattr(
        cc, "fused_transpose_reference",
        lambda *a, **k: port_calls.append(1) or plain(*a, **k),
    )
    monkeypatch.setattr(
        ref_pc, "fused_transpose_dot_kl",
        lambda *a, **k: ref_calls.append(1) or kernel(*a, **k),
    )
    port_sc.reset_routed()
    got = complex(contract_tensor_network(
        tn, path, TorchBackend(device="cpu", split_complex=True)
    ).data.into_data())
    routed = dict(port_sc.FUSED_TRANSPOSE_ROUTED)
    oracle = complex(contract_tensor_network(tn, path, NumpyBackend()).data.into_data())

    ref_program = build_program(ref_tn, ref_path)
    arrays = [leaf.data.into_data() for leaf in flat_leaf_tensors(ref_tn)]
    obs.configure(enabled=True, registry=obs.MetricsRegistry())
    try:
        want = complex(np.asarray(JaxBackend(
            dtype="complex64", split_complex=True, precision="float32"
        ).execute(ref_program, arrays)).reshape(()))
        counters = obs.get_registry().snapshot()["counters"]
    finally:
        obs.configure(enabled=False)

    assert 0.1 < abs(oracle) < 10.0  # the O(1) scale keeps float32 in range
    assert abs(got - want) <= 1e-4 * abs(want)
    assert abs(got - oracle) <= 1e-4 * abs(oracle)
    assert abs(want - oracle) <= 1e-4 * abs(oracle)
    assert len(port_calls) == len(ref_calls) == 2
    assert routed == _ref_routed(counters)
    assert sum(routed.values()) + 2 == len(ref_program.steps)


@pytest.mark.parametrize("args", PEPS_ARGS + [(2, 2, 3, 2, 0), (2, 5, 2, 4, 2)])
def test_peps_builder_matches_reference(args):
    """Legs and dims, leaf by leaf, in the same order."""
    port, ref = port_peps(*args), ref_peps(*args)
    assert len(port.tensors) == len(ref.tensors) == (args[4] + 2) * args[0] * args[1]
    for p, r in zip(port.tensors, ref.tensors):
        assert (p.legs, p.bond_dims) == (list(r.legs), list(r.bond_dims))
    with pytest.raises(ValueError):
        port_peps(1, 3, 2, 2, 0)


@pytest.mark.parametrize("scale", [None, 2.0 ** -3.5])
def test_attach_random_data_matches_reference(scale):
    """Same Generator, same scale: identical complex128 arrays."""
    for args in [(3, 3, 2, 16, 0), (2, 3, 2, 4, 1)]:
        port = attach_random_data(port_peps(*args), np.random.default_rng(5), scale)
        ref = ref_attach(ref_peps(*args), np.random.default_rng(5), scale)
        for p, r in zip(port.tensors, ref.tensors):
            got, want = p.data.into_data(), r.data.into_data()
            assert got.dtype == np.complex128
            assert np.array_equal(got, want)


def test_unit_scale_keeps_the_norm_of_order_one():
    """The scale rule on the main configuration (2^-4.5), and |Z| of order
    one on a small network."""
    assert unit_scale(port_peps(4, 4, 2, 32, 0)) == 2.0 ** -4.5
    tn = port_peps(3, 3, 2, 8, 0)
    attach_random_data(tn, np.random.default_rng(1), scale=unit_scale(tn))
    path = PortGreedy(PortOptMethod.GREEDY).find_path(tn).replace_path()
    z = complex(contract_tensor_network(tn, path, NumpyBackend()).data.into_data())
    assert 0.05 < abs(z) < 20.0
    assert math.isfinite(abs(z))


# (view, k_axes, f_axes, storage offset, copy mode by dtype): the stride-1
# index is walked, 16 bytes at a time when its digit is a whole number of
# vectors and every other stride and the base are aligned
GATHER_MODES = [
    ((2, 32, 32), (1,), (0, 2), 0, {"float32": "VEC", "float64": "VEC"}),  # k_unit 0
    ((2, 32, 32), (2,), (0, 1), 0, {"float32": "VEC_K", "float64": "VEC_K"}),  # k_unit 1
    ((2, 32, 6), (2,), (0, 1), 0, {"float32": "WALK_K", "float64": "VEC_K"}),  # digit 6
    ((2, 6, 5), (1,), (0, 2), 0, {"float32": "WALK_F", "float64": "WALK_F"}),  # digit 5
    ((2, 32, 32), (2,), (0, 1), 1, {"float32": "WALK_K", "float64": "WALK_K"}),
    ((2, 32, 32), (1,), (0, 2), 1, {"float32": "WALK_F", "float64": "WALK_F"}),
]


@pytest.mark.parametrize("view,k_axes,f_axes,offset,modes", GATHER_MODES)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_gather_copy_mode_rules(view, k_axes, f_axes, offset, modes, dtype):
    """Which copy the transpose kernel makes of a stored operand: 16-byte
    copies along the stride-1 index (``COPY_VEC_K`` when that is the
    contract index, which selects the staged pipeline) only when four (or
    two) consecutive indices are one aligned run of the storage."""
    n = math.prod(view)
    base = torch.zeros(n + offset, dtype=getattr(torch, dtype))
    t = base[offset:].view(view)
    assert t.storage_offset() == offset
    lay = cc.OperandLayout(view, k_axes, f_axes)
    assert cc.gather_copy_mode(t, t, lay) == getattr(cc, "COPY_" + modes[dtype])
    if offset == 0:
        # one misaligned part is enough to leave the 16-byte copies
        shifted = torch.zeros(n + 1, dtype=t.dtype)[1:].view(view)
        assert cc.gather_copy_mode(t, shifted, lay) in (cc.COPY_WALK_K, cc.COPY_WALK_F)


def test_gather_copy_mode_int64_tables_walk_the_contract_index():
    """The staged pipeline is built for int32 tables only: with int64
    tables a stride-1 contract index is copied element-wise, while 16-byte
    copies along the free index stay."""
    t = torch.zeros(2, 32, 32)
    k_fast = cc.OperandLayout((2, 32, 32), (2,), (0, 1))
    f_fast = cc.OperandLayout((2, 32, 32), (1,), (0, 2))
    assert cc.gather_copy_mode(t, t, k_fast, "int64") == cc.COPY_WALK_K
    assert cc.gather_copy_mode(t, t, k_fast, "int32") == cc.COPY_VEC_K
    assert cc.gather_copy_mode(t, t, f_fast, "int64") == cc.COPY_VEC


def test_gather_copy_mode_needs_aligned_outer_strides():
    """A row stride that is not a whole number of vectors breaks the
    alignment of every row after the first."""
    t = torch.zeros(2, 5, 9)[..., :8]  # strides (45, 9, 1)
    lay = cc.OperandLayout((2, 5, 8), (2,), (0, 1))
    assert cc.gather_copy_mode(t, t, lay) == cc.COPY_WALK_K
    lay_f = cc.OperandLayout((2, 5, 8), (1,), (0, 2))
    assert cc.gather_copy_mode(t, t, lay_f) == cc.COPY_WALK_F


def test_offset_table_width():
    """int32 tables where every offset of the storage fits 31 bits (the
    PEPS operands: at most 2^24 elements), int64 beyond."""
    peps = (2, 32, 8192, 32)
    assert cc.offset_dtype(peps, torch.empty(0).new_empty(peps).stride()) == "int32"
    assert cc.offset_dtype((2, 2**30), (2**30, 1)) == "int32"  # top offset 2^31 - 1
    assert cc.offset_dtype((2, 2**30), (2**30 + 1, 1)) == "int64"  # top offset 2^31
    t = torch.zeros(2, 8, 4)
    lay = cc.OperandLayout((2, 8, 4), (1,), (0, 2))
    off_k, off_f = cc._gather_tables(t, lay)
    assert off_k.dtype == off_f.dtype == torch.int32
    wide_k, wide_f = cc._gather_tables(t, lay, "int64")
    assert wide_k.dtype == torch.int64 and torch.equal(wide_k, off_k.long())
    assert torch.equal(wide_f, off_f.long())


# the layouts of the card tests (tests/test_torch_cuda.py, PEPS_LAYOUTS),
# with each operand's k_unit and copy mode in float32
CARD_LAYOUTS = [
    (((2, 32, 32), (1,), (0, 2)), 0, "VEC"),
    (((2, 32, 1024), (1,), (0, 2)), 0, "VEC"),
    (((2, 32, 32, 8, 32), (1, 3), (0, 2, 4)), 0, "VEC"),
    (((64, 32, 37, 8), (1, 3), (0, 2)), 1, "VEC_K"),
]


@pytest.mark.parametrize("layout,k_unit,mode", CARD_LAYOUTS)
def test_k_unit_on_the_card_test_layouts(layout, k_unit, mode):
    """``k_unit`` (the contract index has the smaller stride) and the copy
    mode of each operand the card tests hand the kernel: the mode walks or
    vectorises the contract index exactly when ``k_unit``, with int32 and
    with int64 offset tables."""
    lay = cc.OperandLayout(*layout)
    t = torch.zeros(lay.view)
    assert int(t.stride(lay.kd) < t.stride(lay.fd)) == k_unit
    along_k = (cc.COPY_VEC_K, cc.COPY_WALK_K)
    got = cc.gather_copy_mode(t, t, lay)
    assert got == getattr(cc, "COPY_" + mode)
    assert (got in along_k) == bool(k_unit)
    assert (cc.gather_copy_mode(t, t, lay, "int64") in along_k) == bool(k_unit)
