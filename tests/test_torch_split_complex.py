"""The port's split-complex step kernel against the reference's, mode by
mode, on the same (real, imag) buffers.

``apply_step_split`` runs each step under ``naive`` / ``gauss`` /
``fused`` / ``strassen``; the reference runs the same step through
``jax.numpy`` (Pallas in interpret mode for ``fused``) and its numpy host
oracle. Small programs never clear the fused kernel's flop floor or the
Strassen crossover, so those two modes also run on constructed steps
(k = m = n = 128 gives 2kmn = 2^22 exactly; Strassen needs every dim
≥ 2^11).

Tolerance: float32 max|Δ| ≤ 1e-5·max|ref| per step; whole programs
1e-4·max|ref| against the reference's float32 run.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tnc_tpu.ops.split_complex as ref_sc
import tnc_tpu.tensornetwork.tensor as ref_tensor
from tnc_tpu.builders.connectivity import ConnectivityLayout
from tnc_tpu.contractionpath.contraction_path import ContractionPath
from tnc_tpu.contractionpath.paths import Greedy, OptMethod
from tnc_tpu.ops.backends import place_buffers as ref_place
from tnc_tpu.ops.program import build_program, flat_leaf_tensors
from tnc_tpu_torch.interop import network_from_arrays, path_from_pairs
from tnc_tpu_torch.ops import program as port_prog
from tnc_tpu_torch.ops import split_complex as port_sc
from tnc_tpu_torch.ops.backends import place_buffers as port_place

ref_rc = importlib.import_module("tnc_tpu.builders.random_circuit")


def _rel_err(got, want):
    got = [np.asarray(g, dtype=np.float64) for g in got]
    want = [np.asarray(w, dtype=np.float64) for w in want]
    scale = max(float(np.max(np.abs(w))) for w in want)
    return max(float(np.max(np.abs(g - w))) for g, w in zip(got, want)) / scale


def _programs(qubits=10, seed=42):
    tn = ref_rc.random_circuit(
        qubits, 12, 0.4, 0.4, np.random.default_rng(seed),
        ConnectivityLayout.SYCAMORE, bitstring="*" * qubits,
    )
    path = Greedy(OptMethod.GREEDY).find_path(tn).replace_path()
    arrays = [l.data.into_data() for l in flat_leaf_tensors(tn)]
    leaves = [(l.legs, l.bond_dims, l.data.into_data()) for l in flat_leaf_tensors(tn)]
    port = port_prog.build_program(network_from_arrays(leaves), path_from_pairs(path.toplevel))
    return build_program(tn, path), port, arrays


def _pair_step(a_legs, a_dims, b_legs, b_dims):
    """One-step programs (reference and port) over two random leaves."""
    tn = ref_tensor.CompositeTensor([
        ref_tensor.LeafTensor(a_legs, a_dims), ref_tensor.LeafTensor(b_legs, b_dims),
    ])
    ref = build_program(tn, ContractionPath.simple([(0, 1)]))
    port = port_prog.build_program(
        network_from_arrays([(a_legs, a_dims, np.zeros(a_dims)),
                             (b_legs, b_dims, np.zeros(b_dims))]),
        path_from_pairs([(0, 1)]),
    )
    return ref.steps[0], port.steps[0]


def _operands(ref_step, rng, dtype=np.float32):
    a = rng.standard_normal((2, int(np.prod(ref_step.a_view)))).astype(dtype)
    b = rng.standard_normal((2, int(np.prod(ref_step.b_view)))).astype(dtype)
    return a, b


def _run_both(ref_step, port_step, a, b, mode):
    got = port_sc.apply_step_split(
        tuple(torch.from_numpy(x.copy()) for x in a),
        tuple(torch.from_numpy(x.copy()) for x in b), port_step, mode=mode,
    )
    want = ref_sc.apply_step_split(
        jnp, tuple(jnp.asarray(x) for x in a), tuple(jnp.asarray(x) for x in b),
        ref_step, "float32", mode=mode,
    )
    oracle = ref_sc.apply_step_split(
        np, tuple(x.astype(np.float64) for x in a),
        tuple(x.astype(np.float64) for x in b), ref_step, mode=mode,
    )
    return [g.numpy() for g in got], want, oracle


@pytest.mark.parametrize("mode", ["naive", "gauss", "fused", "strassen"])
def test_apply_step_split_per_mode_on_program_steps(mode):
    """Every step of a 10-qubit program, each mode: the port against the
    reference's jax.numpy step and its float64 numpy oracle. (No step
    of this program clears the fused floor or the Strassen crossover:
    ``fused`` routes each to naive dots, ``strassen`` to gauss.)"""
    ref_program, port_program, _ = _programs()
    rng = np.random.default_rng(0)
    port_sc.reset_routed()
    for ref_step, port_step in zip(ref_program.steps, port_program.steps):
        a, b = _operands(ref_step, rng)
        got, want, oracle = _run_both(ref_step, port_step, a, b, mode)
        assert got[0].shape == tuple(ref_step.out_store) == want[0].shape
        assert _rel_err(got, want) <= 1e-5
        assert _rel_err(got, oracle) <= 1e-5
    routed = dict(port_sc.FUSED_ROUTED)
    if mode == "fused":
        assert sum(routed.values()) == len(port_program.steps)
        assert set(routed) <= {"layout", "flop_floor"}
    else:
        assert routed == {}


def test_fused_mode_on_a_constructed_step():
    """k = m = n = 128, both operands contract-first: the step clears
    the flop floor and runs the fused kernel's function (its plain
    version on CPU), against the reference's Pallas kernel in interpret
    mode."""
    ref_step, port_step = _pair_step([1, 0], [128, 128], [1, 2], [128, 128])
    assert ref_step.a_cfirst and ref_step.b_cfirst
    port_sc.reset_routed()
    a, b = _operands(ref_step, np.random.default_rng(1))
    got, want, oracle = _run_both(ref_step, port_step, a, b, "fused")
    assert port_sc.FUSED_ROUTED == {}
    assert _rel_err(got, want) <= 1e-5
    assert _rel_err(got, oracle) <= 1e-5


def test_fused_mode_routes_layout_and_flop_floor():
    """A contract-last operand is routed by ``layout``; a small step by
    ``flop_floor``; both then run the naive dots."""
    cases = [
        ([0, 1], [128, 128], [1, 2], [128, 128]),  # a is contract-last
        ([1, 0], [8, 8], [1, 2], [8, 8]),  # under the floor
    ]
    port_sc.reset_routed()
    for args in cases:
        ref_step, port_step = _pair_step(*args)
        a, b = _operands(ref_step, np.random.default_rng(2))
        got, want, _ = _run_both(ref_step, port_step, a, b, "fused")
        assert _rel_err(got, want) <= 1e-5
    assert port_sc.FUSED_ROUTED == {"layout": 1, "flop_floor": 1}


def test_strassen_mode_on_a_constructed_step():
    """A 2048^3 step clears the Strassen crossover: one Strassen level on
    the Gauss identity, in both packages, against the float64 oracle at
    the reference's documented float32 rung (2e-5 relative)."""
    ref_step, port_step = _pair_step([1, 0], [2048, 2048], [1, 2], [2048, 2048])
    assert port_sc.resolved_step_mode(port_step, "strassen") == "strassen"
    a, b = _operands(ref_step, np.random.default_rng(3))
    got, want, oracle = _run_both(ref_step, port_step, a, b, "strassen")
    assert _rel_err(got, oracle) <= 2e-5
    assert _rel_err(want, oracle) <= 2e-5
    assert _rel_err(got, want) <= 4e-5


@pytest.mark.parametrize("force", ["auto", "chain", "naive", "gauss", "fused"])
def test_run_steps_split_whole_program(force, monkeypatch):
    """A whole 10-qubit program under each forcing mode: the port's
    ``run_steps_split`` against the reference's, same policy."""
    monkeypatch.setenv("TNC_TPU_COMPLEX_MULT", force)
    ref_program, port_program, arrays = _programs()
    ref_policy = ref_sc.plan_kernels(ref_program)
    port_policy = port_sc.plan_kernels(port_program)
    assert ref_policy.signature() == port_policy.signature()
    got = port_sc.run_steps_split(
        port_program, port_place(arrays, "complex64", True, "cpu"), "float32",
        policy=port_policy,
    )
    want = ref_sc.run_steps_split(
        jnp, ref_program, ref_place(arrays, "complex64", True), "float32",
        policy=ref_policy,
    )
    assert _rel_err([g.numpy() for g in got], want) <= 1e-4


def test_float64_parts_stay_float64():
    """complex128 split pairs (float64 parts) run every mode in float64,
    matching the float64 numpy oracle to 1e-12."""
    ref_program, port_program, _ = _programs(8, 5)
    rng = np.random.default_rng(4)
    for mode in ("naive", "gauss"):
        for ref_step, port_step in zip(ref_program.steps, port_program.steps):
            a, b = _operands(ref_step, rng, np.float64)
            got = port_sc.apply_step_split(
                tuple(torch.from_numpy(x) for x in a),
                tuple(torch.from_numpy(x) for x in b), port_step, mode=mode,
            )
            assert got[0].dtype == torch.float64
            oracle = ref_sc.apply_step_split(np, a, b, ref_step, mode=mode)
            assert _rel_err([g.numpy() for g in got], oracle) <= 1e-12


def test_forcing_knobs(monkeypatch):
    monkeypatch.setenv("TNC_TPU_DOT_PRECISION", "hi")
    with pytest.raises(ValueError):
        ref_sc.dot_precision_forced()
    with pytest.raises(ValueError):
        port_sc.dot_precision_forced()
    monkeypatch.setenv("TNC_TPU_DOT_PRECISION", "auto")
    assert port_sc.dot_precision_forced() is ref_sc.dot_precision_forced() is None
    monkeypatch.setenv("TNC_TPU_COMPLEX_MULT", "fused_transpose")
    with pytest.raises(NotImplementedError, match="not ported"):
        port_sc.complex_mult_forced()
    monkeypatch.delenv("TNC_TPU_COMPLEX_MULT")
    assert port_sc.complex_mult_env() == ref_sc.complex_mult_env() == "gauss"
    assert port_sc.complex_mult_key() == ref_sc.complex_mult_key() == "auto"


def test_split_and_combine_round_trip():
    x = np.array([[1 + 2j, 3 - 4j], [0.5j, -1.0]])
    re, im = port_sc.split_array(x)
    assert re.dtype == np.float32
    assert np.array_equal(port_sc.combine_array(re, im), ref_sc.combine_array(re, im))
    t = port_sc.combine_array(torch.from_numpy(re), torch.from_numpy(im))
    assert np.allclose(t, x)


def test_gauss_matmul_matches_reference():
    rng = np.random.default_rng(6)
    ar, ai = (rng.standard_normal((5, 7)) for _ in range(2))
    br, bi = (rng.standard_normal((7, 3)) for _ in range(2))
    got = port_sc.gauss_matmul(*(torch.from_numpy(x) for x in (ar, ai, br, bi)))
    want = ref_sc.gauss_matmul(np, ar, ai, br, bi)
    assert _rel_err([g.numpy() for g in got], want) <= 1e-12
