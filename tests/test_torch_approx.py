"""The port's approximate tier (``tnc_tpu_torch.tensornetwork.approximate``
boundary-MPS contractor and ``tnc_tpu_torch.approx``) against the JAX
package on the CPU.

- Grids: ``collapse_peps_sandwich``, ``circuit_to_grid`` and
  ``sandwich_to_grid`` give bitwise the reference's leaves; geometry and
  the closed-form costs (``grid_site_dims``, ``row_cost``, ``close_cost``,
  ``sweep_cost``, ``exact_chi_bound``, ``default_chis``, ``rung_seconds``)
  are equal.
- Sweeps: the numpy sweep is bitwise the reference's (value and weight);
  the ``torch`` sweep on the CPU in complex128 is within 1e-10 of the
  reference's ``backend="jax"`` sweep (x64), in complex64 within 1e-4;
  its spans carry the row costs, bytes at the sweep dtype's width.
- ``ChiLadder``: on numpy, bitwise the reference's rungs; its error
  estimate bounds the true error on the reference's PEPS and brickwork
  seeds, on numpy and on the ``torch`` sweep; ``_fp_floor`` reads the
  sweep's dtype.
- Errors: the reference's messages; with no backend or device given the
  sweep, the program and the ladder take CUDA and raise without it.
"""

import dataclasses
import doctest
import functools

import numpy as np
import pytest

import tnc_tpu.approx as ref_approx
import tnc_tpu.tensornetwork.approximate as ref_am
import tnc_tpu_torch.approx.cost as port_cost
import tnc_tpu_torch.approx.ladder as port_ladder
import tnc_tpu_torch.approx.program as port_program
import tnc_tpu_torch.tensornetwork.approximate as port_am
from tnc_tpu import obs as ref_obs
from tnc_tpu.builders.circuit_builder import Circuit as RefCircuit
from tnc_tpu.builders.peps import peps as ref_peps
from tnc_tpu.builders.qaoa_circuit import qaoa_circuit as ref_qaoa
from tnc_tpu.builders.random_circuit import brickwork_circuit as ref_brickwork
from tnc_tpu.contractionpath.paths import Greedy as RefGreedy
from tnc_tpu.contractionpath.paths import OptMethod as RefOptMethod
from tnc_tpu.obs.calibrate import CalibratedCostModel as RefCostModel
from tnc_tpu.queries import statevector as ref_sv
from tnc_tpu.tensornetwork.contraction import contract_tensor_network as ref_contract
from tnc_tpu.tensornetwork.tensordata import TensorData as RefTensorData
from tnc_tpu_torch import obs
from tnc_tpu_torch.approx import (
    ApproxProgram,
    ChiLadder,
    circuit_to_grid,
    default_chis,
    exact_chi_bound,
    ladder_seconds,
    rung_seconds,
    sandwich_to_grid,
    sweep_cost,
)
from tnc_tpu_torch.builders.circuit_builder import Circuit
from tnc_tpu_torch.builders.peps import peps
from tnc_tpu_torch.builders.qaoa_circuit import qaoa_circuit
from tnc_tpu_torch.builders.random_circuit import brickwork_circuit
from tnc_tpu_torch.obs.calibrate import CalibratedCostModel
from tnc_tpu_torch.queries import statevector as sv
from tnc_tpu_torch.tensornetwork.approximate import (
    attach_random_data,
    boundary_contract_with_weight,
    boundary_mps_contract,
    close_cost,
    collapse_peps_sandwich,
    grid_site_dims,
    row_cost,
)
from tnc_tpu_torch.tensornetwork.tensordata import TensorData


def _same_grid(grid, ref_grid):
    assert len(grid) == len(ref_grid)
    for row, ref_row in zip(grid, ref_grid):
        assert len(row) == len(ref_row)
        for a, b in zip(row, ref_row):
            assert list(a.legs) == list(b.legs)
            assert list(a.bond_dims) == list(b.bond_dims)
            x, y = np.asarray(a.data.into_data()), np.asarray(b.data.into_data())
            assert x.dtype == y.dtype and np.array_equal(x, y)


@functools.lru_cache(maxsize=None)
def _peps(length, depth, layers, seed, port):
    """A seeded ``peps(length, depth, 2, 2, layers)`` sandwich collapsed to
    its grid, and (reference side) its exact value by ``Greedy`` on numpy."""
    rng = np.random.default_rng(seed)
    if port:
        tn = attach_random_data(peps(length, depth, 2, 2, layers), rng)
        return collapse_peps_sandwich(tn, length, depth, layers), None
    tn = ref_am.attach_random_data(ref_peps(length, depth, 2, 2, layers), rng)
    path = RefGreedy(RefOptMethod.GREEDY).find_path(tn).replace_path()
    want = complex(np.asarray(ref_contract(tn, path, backend="numpy").data.into_data())
                   .reshape(-1)[0])
    return ref_am.collapse_peps_sandwich(tn, length, depth, layers), want


def _program(kind, seed, port):
    """The port's or the reference's ``ApproxProgram``: a PEPS value
    (``peps``), a brickwork amplitude (``amp``) or a QAOA ⟨Z₀Z₁⟩ sandwich
    (``qaoa``; the MaxCut term of one edge, whose value does not cancel:
    ⟨Z…Z⟩ over all six qubits is ~1e-19 on these seeds)."""
    approx = port_program.ApproxProgram if port else ref_approx.ApproxProgram
    if kind == "peps":
        grid = _peps(4, 4, 1, seed, port)[0]
        return approx(grid=[list(r) for r in grid], kind="value")
    if kind == "amp":
        c = (brickwork_circuit if port else ref_brickwork)(8, 6, np.random.default_rng(seed))
        return approx.from_circuit(c).rebind_bits("10100110")
    c = (qaoa_circuit if port else ref_qaoa)(6, 2, np.random.default_rng(seed))
    return approx.sandwich_from_circuit(c).rebind_pauli("zz" + "i" * 4)


@pytest.mark.parametrize("module", [port_am, port_cost, port_ladder, port_program],
                         ids=["approximate", "cost", "ladder", "program"])
def test_doctests(module):
    assert doctest.testmod(module).failed == 0


@pytest.mark.parametrize("layers", [0, 1])
def test_collapse_and_geometry_match_reference(layers):
    grid = _peps(4, 3, layers, 5, True)[0]
    ref_grid = _peps(4, 3, layers, 5, False)[0]
    _same_grid(grid, ref_grid)
    assert grid_site_dims(grid) == ref_am.grid_site_dims(ref_grid)
    assert exact_chi_bound(grid) == ref_approx.exact_chi_bound(ref_grid)
    assert default_chis(grid, 2, 8) == ref_approx.default_chis(ref_grid, 2, 8)


@pytest.mark.parametrize("seed", [1, 9])
def test_circuit_grids_match_reference(seed):
    c = brickwork_circuit(6, 5, np.random.default_rng(seed))
    ref = ref_brickwork(6, 5, np.random.default_rng(seed))
    grid, bras = circuit_to_grid(c)
    ref_grid, ref_bras = ref_approx.circuit_to_grid(ref)
    _same_grid(grid, ref_grid)
    assert len(bras) == len(ref_bras) == 6
    grid, ops = sandwich_to_grid(c)
    ref_grid, ref_ops = ref_approx.sandwich_to_grid(ref)
    _same_grid(grid, ref_grid)
    _same_grid([ops], [ref_ops])
    # the QAOA circuit of config #4 at a small width
    _same_grid(sandwich_to_grid(qaoa_circuit(6, 2, np.random.default_rng(seed)))[0],
               ref_approx.sandwich_to_grid(ref_qaoa(6, 2, np.random.default_rng(seed)))[0])


@pytest.mark.parametrize("kind", ["peps", "amp", "qaoa"])
def test_costs_match_reference(kind):
    prog, ref = _program(kind, 3, True), _program(kind, 3, False)
    dims = prog.site_dims()
    assert dims == ref.site_dims()
    model = (1.3e12, 2.0e-5, 9.0e11)
    for chi in (1, 2, 3, 8, 64):
        # the two packages' dataclasses, field by field
        want = dataclasses.astuple(ref_approx.sweep_cost(ref, chi))
        assert dataclasses.astuple(sweep_cost(prog, chi)) == want
        assert dataclasses.astuple(prog.sweep_cost(chi)) == want
        assert rung_seconds(prog, chi, CalibratedCostModel(*model)) == ref_approx.rung_seconds(
            ref, chi, RefCostModel(*model))
    assert ladder_seconds(dims, (2, 4, 8), CalibratedCostModel(*model)) == (
        ref_approx.ladder_seconds(ref.site_dims(), (2, 4, 8), RefCostModel(*model)))
    assert exact_chi_bound(dims) == ref_approx.exact_chi_bound(dims)
    assert exact_chi_bound(dims, cap=4) == ref_approx.exact_chi_bound(dims, cap=4)
    assert default_chis(prog) == ref_approx.default_chis(ref)
    assert default_chis(dims, 3, 16) == ref_approx.default_chis(dims, 3, 16)
    # the row and close helpers on the sweep's own shapes
    mps = [(l, d, r) for (l, r, _u, d) in dims[0]]
    for row in dims[1:-1]:
        mpo = list(row)
        got = row_cost(mps, mpo, 4)
        assert got == ref_am.row_cost(mps, mpo, 4)
        mps = got[3]
    bottom = [(l, u, r) for (l, r, u, _d) in dims[-1]]
    assert close_cost(mps, bottom) == ref_am.close_cost(mps, bottom)


@pytest.mark.parametrize("kind", ["peps", "amp", "qaoa"])
def test_sweeps_match_reference(kind):
    prog, ref = _program(kind, 7, True), _program(kind, 7, False)
    for chi in (2, 4, 16):
        got = boundary_contract_with_weight(prog.grid, chi, backend="numpy")
        want = ref_am.boundary_contract_with_weight(ref.grid, chi)
        assert got == want  # numpy: bitwise, value and weight
        assert boundary_mps_contract(prog.grid, chi, backend="numpy") == want[0]
        if chi == 4:
            continue  # the reference's jitted sweep compiles per row shape and chi
        jax_value, jax_weight = ref_am.boundary_contract_with_weight(ref.grid, chi,
                                                                     backend="jax")
        value, weight = prog.contract(chi, backend="torch", dtype="complex128", device="cpu")
        scale = abs(jax_value)
        assert abs(value - jax_value) <= 1e-10 * scale
        assert abs(weight - jax_weight) <= 1e-10 * max(jax_weight, 1.0)
        value32, weight32 = prog.contract(chi, backend="torch", device="cpu")
        assert abs(value32 - jax_value) <= 1e-4 * scale
        assert abs(weight32 - jax_weight) <= 1e-4 * max(jax_weight, 1.0)


@pytest.mark.parametrize("dtype,itemsize", [("complex128", 16), ("complex64", 8)])
def test_torch_sweep_spans_carry_row_costs(monkeypatch, dtype, itemsize):
    """Each ``approx.row`` span of the ``torch`` sweep carries its row's
    flops and its bytes at the sweep dtype's width."""
    registry = obs.MetricsRegistry()
    monkeypatch.setattr(obs.core, "_REGISTRY", registry)
    monkeypatch.setattr(obs.core, "_ENABLED", True)
    prog = _program("amp", 3, True)
    prog.contract(4, backend="torch", dtype=dtype, device="cpu")
    records = registry.span_records()
    sweeps = [r for r in records if r.name == "approx.sweep"]
    rows = [r for r in records if r.name == "approx.row"]
    assert len(sweeps) == 1 and sweeps[0].args["backend"] == "torch"
    assert len(rows) == len(prog.grid) - 2
    assert port_am.elem_bytes("torch", dtype) == itemsize
    cost = prog.sweep_cost(4, itemsize)
    assert [(r.args["flops"], r.args["bytes"]) for r in rows] == [
        (f, b) for f, b, _ in cost.rows[:-1]]
    # bytes scale with the element width; flops do not
    wide = prog.sweep_cost(4)
    assert cost.flops == wide.flops and cost.nbytes * 16 == wide.nbytes * itemsize


def test_ladder_on_numpy_matches_reference_bitwise():
    for kind, kw in (("peps", {"chi_cap": 256}), ("amp", {"chis": (2, 3, 4, 8)}),
                     ("qaoa", {"chi_cap": 64})):
        prog, ref = _program(kind, 3, True), _program(kind, 3, False)
        got = ChiLadder(**kw).run(prog, rtol=1e-8, scale=1e-3, backend="numpy")
        want = ref_approx.ChiLadder(**kw).run(ref, rtol=1e-8, scale=1e-3)
        assert [dataclasses.astuple(r) for r in got.rungs] == [
            dataclasses.astuple(r) for r in want.rungs]
        assert (got.value, got.err, got.chi_used, got.converged) == (
            want.value, want.err, want.chi_used, want.converged)
    model = (1.3e12, 2.0e-5, 9.0e11)
    got = ChiLadder(chi_cap=16).run(_program("peps", 3, True), rtol=1e-8, backend="numpy",
                                    cost_model=CalibratedCostModel(*model))
    want = ref_approx.ChiLadder(chi_cap=16).run(_program("peps", 3, False), rtol=1e-8,
                                                cost_model=RefCostModel(*model))
    assert [r.predicted_s for r in got.rungs] == [r.predicted_s for r in want.rungs]


@pytest.mark.parametrize("backend", ["numpy", "torch"])
@pytest.mark.parametrize("seed", [3, 7, 11, 19])
def test_ladder_estimate_bounds_true_error_on_peps(seed, backend):
    prog = _program("peps", seed, True)
    want = _peps(4, 4, 1, seed, False)[1]
    kw = {"dtype": "complex128", "device": "cpu"} if backend == "torch" else {}
    res = ChiLadder(chi_cap=256).run(prog, rtol=1e-8, scale=abs(want), backend=backend, **kw)
    assert res.converged
    for rung in res.rungs:
        assert rung.err >= abs(rung.value - want), (rung.chi, rung.err)
    chis = [r.chi for r in res.rungs]
    assert chis == sorted(chis)
    assert res.rungs[-1].weight <= res.rungs[0].weight


@pytest.mark.parametrize("backend", ["numpy", "torch"])
@pytest.mark.parametrize("seed", [1, 9])
def test_ladder_estimate_bounds_true_error_on_circuit(seed, backend):
    circuit = brickwork_circuit(10, 8, np.random.default_rng(seed))
    bits = "1010011010"
    want = sv.amplitude(sv.statevector(circuit.copy()), bits)
    ref_circuit = ref_brickwork(10, 8, np.random.default_rng(seed))
    assert want == ref_sv.amplitude(ref_sv.statevector(ref_circuit), bits)
    prog = ApproxProgram.from_circuit(circuit).rebind_bits(bits)
    assert exact_chi_bound(prog.grid) > 3
    kw = {"dtype": "complex64", "device": "cpu"} if backend == "torch" else {}
    res = ChiLadder(chis=(2, 3, 4, 8, 16)).run(prog, rtol=1e-12, scale=2.0 ** -5,
                                               backend=backend, **kw)
    assert len(res.rungs) >= 2
    for rung in res.rungs:
        assert rung.err >= abs(rung.value - want), (rung.chi, rung.err)


def test_fp_floor_reads_the_sweep_dtype():
    from tnc_tpu_torch.approx.ladder import COMPLEX64_ERR_REL, EXACT_ERR_REL, _fp_floor

    assert (COMPLEX64_ERR_REL, EXACT_ERR_REL) == (ref_approx.ladder.COMPLEX64_ERR_REL,
                                                  ref_approx.ladder.EXACT_ERR_REL)
    assert _fp_floor("numpy") == _fp_floor("numpy", "complex64") == EXACT_ERR_REL
    assert _fp_floor("torch", "complex128") == EXACT_ERR_REL
    assert _fp_floor("torch") == _fp_floor("torch", "complex64") == COMPLEX64_ERR_REL
    # an untruncated complex64 rung claims the float32 bar, not the float64 one
    prog = _program("amp", 3, True)
    top = exact_chi_bound(prog)
    res = ChiLadder(chis=(top,)).run(prog, rtol=0.5, scale=1.0, backend="torch", device="cpu")
    assert res.rungs[0].weight <= port_am.EXACT_WEIGHT
    assert res.err == COMPLEX64_ERR_REL * max(abs(res.value), 1.0)


def test_rebinding_matches_reference():
    c, ref = brickwork_circuit(5, 4, np.random.default_rng(2)), ref_brickwork(
        5, 4, np.random.default_rng(2))
    sand, ref_sand = ApproxProgram.sandwich_from_circuit(c), ref_approx.ApproxProgram.\
        sandwich_from_circuit(ref)
    for rebind in (lambda p: p.rebind_pauli("zxiyz"),
                   lambda p: p.rebind_projectors("0*1*1"),
                   lambda p: p.rebind_operators([None, np.diag([2.0, 0.5]), None, None, None])):
        assert rebind(sand).contract(8, backend="numpy") == rebind(ref_sand).contract(8)
    amp, ref_amp = ApproxProgram.from_circuit(c), ref_approx.ApproxProgram.from_circuit(ref)
    assert amp.rebind_bits("01101").contract(8, backend="numpy") == (
        ref_amp.rebind_bits("01101").contract(8))


def _message(fn, exc=ValueError) -> str:
    with pytest.raises(exc) as info:
        fn()
    return str(info.value)


def test_errors_match_reference(monkeypatch):
    import torch

    prog, ref = _program("amp", 3, True), _program("amp", 3, False)
    sand = _program("qaoa", 3, True)
    ref_sand = _program("qaoa", 3, False)
    for call, ref_call in (
        (lambda: prog.rebind_bits("0101*110"), lambda: ref.rebind_bits("0101*110")),
        (lambda: prog.rebind_pauli("z" * 8), lambda: ref.rebind_pauli("z" * 8)),
        (lambda: sand.rebind_bits("0" * 6), lambda: ref_sand.rebind_bits("0" * 6)),
        (lambda: sand.rebind_operators([np.eye(3)] + [None] * 5),
         lambda: ref_sand.rebind_operators([np.eye(3)] + [None] * 5)),
        (lambda: sand.rebind_operators([None] * 4), lambda: ref_sand.rebind_operators(
            [None] * 4)),
        (lambda: boundary_mps_contract(prog.grid, 0), lambda: ref_am.boundary_mps_contract(
            ref.grid, 0)),
        (lambda: ChiLadder(chis=(4, 2)), lambda: ref_approx.ChiLadder(chis=(4, 2))),
        (lambda: ChiLadder().run(prog, rtol=0.0), lambda: ref_approx.ChiLadder().run(
            ref, rtol=0.0)),
    ):
        assert _message(call) == _message(ref_call)
    c = Circuit()
    reg = c.allocate_register(3)
    c.append_gate(TensorData.gate("cx"), [reg.qubit(0), reg.qubit(2)])
    r = RefCircuit()
    ref_reg = r.allocate_register(3)
    r.append_gate(RefTensorData.gate("cx"), [ref_reg.qubit(0), ref_reg.qubit(2)])
    assert _message(lambda: circuit_to_grid(c)) == _message(lambda: ref_approx.circuit_to_grid(r))
    with pytest.raises(ValueError, match="unknown backend"):
        boundary_mps_contract(prog.grid, 4, backend="jax")
    with pytest.raises(ValueError, match="chi truncation only"):
        boundary_mps_contract(prog.grid, 4, cutoff=1e-3, backend="torch", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        prog.contract(4, backend="torch")


@pytest.mark.parametrize("call", [
    lambda prog: prog.contract(4),
    lambda prog: boundary_contract_with_weight(prog.grid, 4),
    lambda prog: boundary_mps_contract(prog.grid, 4),
    lambda prog: ChiLadder(chis=(2, 4)).run(prog, rtol=1e-3),
], ids=["contract", "with_weight", "boundary_mps", "ladder"])
def test_approx_entry_points_without_backend_are_the_card(monkeypatch, call):
    """With no backend given, the approximate tier's entry points sweep on
    the card: without CUDA they raise, and never drop to the host."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call(_program("amp", 3, True))


def test_reference_obs_untouched():
    """The port's spans go to the port's registry, never the reference's."""
    assert not ref_obs.enabled()
