"""The port's templates, amplitude sweeps and bra rebinding
(``Circuit.into_amplitude_template`` / ``into_sandwich_template``,
``tnc_tpu_torch.tensornetwork.sweep``, ``tnc_tpu_torch.serve.rebind``)
against the JAX package on the CPU.

- Templates: the same leaves (legs, bond dims, data), ``determined``,
  mask or spec, permutor, trailing slot order and request bits for every
  spec character, and the same errors.
- ``amplitude_sweep``: bitwise the reference's on ``NumpyBackend``; within
  1e-5 of max|ref| on ``TorchBackend(device="cpu")``, split and native;
  the doctest cases, the empty input, the validation errors and the
  wildcard branch (marginal probabilities, bitwise on numpy).
- ``bind_template`` / ``BoundProgram.amplitudes`` on the dispatch
  branches — threaded (``NumpyBackend``), batched (``TorchBackend``, split
  and native, no padding of the batch) and sliced (a ``target_size`` under the plan's peak,
  also with ``slice_range``) — against the reference's bound program on
  its ``NumpyBackend`` (the numpy branch bitwise, the torch branches within
  1e-5 of max|ref|, the complex128 sliced branch within 1e-12), with the
  reference's plan and slicing; ``plan_cache`` and ``reuse_store`` give
  a cold binding's bits (the service planes not ported raise).
- With no backend, ``amplitude_sweep`` (both branches) and
  ``BoundProgram.amplitudes`` take ``TorchBackend()``: they raise without
  CUDA rather than run on the host.

Configurations: ``sycamore_circuit(12, 4)`` and ``(16, 6)`` (rng 42).
"""

import doctest
import functools

import numpy as np
import pytest

import tnc_tpu_torch.builders.circuit_builder as port_cb
import tnc_tpu_torch.serve.rebind as port_rebind
import tnc_tpu_torch.tensornetwork.sweep as port_sweep
from tnc_tpu.builders.circuit_builder import Circuit as RefCircuit
from tnc_tpu.builders.sycamore_circuit import sycamore_circuit as ref_sycamore
from tnc_tpu.ops.backends import NumpyBackend as RefNumpyBackend
from tnc_tpu.ops.program import flat_leaf_tensors as ref_flat
from tnc_tpu.serve.rebind import bind_template as ref_bind_template
from tnc_tpu.tensornetwork.sweep import amplitude_sweep as ref_amplitude_sweep
from tnc_tpu.tensornetwork.tensordata import TensorData as RefTensorData
from tnc_tpu_torch.builders.circuit_builder import Circuit
from tnc_tpu_torch.builders.sycamore_circuit import sycamore_circuit
from tnc_tpu_torch.ops.backends import NumpyBackend, TorchBackend
from tnc_tpu_torch.ops.program import flat_leaf_tensors
from tnc_tpu_torch.serve import bind_circuit, bind_template, plan_signature
from tnc_tpu_torch.serve.rebind import DISPATCH, reset_dispatch
from tnc_tpu_torch.tensornetwork.sweep import amplitude_sweep
from tnc_tpu_torch.tensornetwork.tensordata import TensorData

CASES = {"syc12m4": (12, 4), "syc16m6": (16, 6)}
REL = 1e-5


def _syc(case, port=True):
    q, m = CASES[case]
    return (sycamore_circuit if port else ref_sycamore)(q, m, np.random.default_rng(42))


def _bits(n, b=6, seed=7):
    rows = np.random.default_rng(seed).integers(0, 2, (b - 1, n))
    return ["0" * n] + ["".join(str(int(x)) for x in r) for r in rows]


def _ghz(n, port=True):
    c = (Circuit if port else RefCircuit)()
    data = TensorData if port else RefTensorData
    reg = c.allocate_register(n)
    c.append_gate(data.gate("h"), [reg.qubit(0)])
    for i in range(n - 1):
        c.append_gate(data.gate("cx"), [reg.qubit(i), reg.qubit(i + 1)])
    return c


def _same_network(tn, ref_tn):
    leaves, ref_leaves = flat_leaf_tensors(tn), ref_flat(ref_tn)
    assert len(leaves) == len(ref_leaves)
    for a, b in zip(leaves, ref_leaves):
        assert (a.legs, a.bond_dims) == (b.legs, b.bond_dims)
        assert np.array_equal(a.data.into_data(), b.data.into_data())


@pytest.mark.parametrize("module", [port_cb, port_sweep, port_rebind],
                         ids=["circuit_builder", "sweep", "rebind"])
def test_doctests(module):
    assert doctest.testmod(module).failed == 0


def test_tables_match_reference():
    from tnc_tpu.builders import circuit_builder as ref_cb

    for name in ("BASIS_STATES", "PAULI_MATRICES"):
        got, want = getattr(port_cb, name), getattr(ref_cb, name)
        assert got.keys() == want.keys()
        for k in got:
            assert np.array_equal(got[k], want[k]) and got[k].dtype == want[k].dtype
    y = port_cb.PAULI_MATRICES["y"]
    assert np.array_equal(port_cb.observable_leaf_data(y).into_data(),
                          ref_cb.observable_leaf_data(y).into_data())


@pytest.mark.parametrize("mask", [None, "0101*1*0*1*0", "************", "101100111000",
                                  [0, 1, None, "1", "*", 0, 1, 1, 0, "0", None, 1]])
def test_amplitude_template_matches_reference(mask):
    tpl = _syc("syc12m4").into_amplitude_template(mask)
    ref = _syc("syc12m4", False).into_amplitude_template(mask)
    _same_network(tpl.network, ref.network)
    assert (tpl.num_qubits, tpl.determined, tpl.mask) == (ref.num_qubits, ref.determined,
                                                          ref.mask)
    assert tpl.permutor.target_leg_order == ref.permutor.target_leg_order
    assert tpl.open_positions == ref.open_positions
    # the bras are the trailing leaves, in qubit order
    leaves = flat_leaf_tensors(tpl.network)
    bras = leaves[len(leaves) - len(tpl.determined):]
    edges = [leaf.legs[0] for leaf in bras]
    assert edges == sorted(edges) and all(len(leaf.legs) == 1 for leaf in bras)
    req = "".join("*" if c == "*" else "1" for c in tpl.mask)
    assert tpl.request_bits(req) == ref.request_bits(req)
    assert tpl.normalize_request(req) == ref.normalize_request(req)


@pytest.mark.parametrize("spec", ["????", "****", "oooo", "pppp", "?*o?", "p*op", "o*?*",
                                  "*?**", "*p*o"])
def test_sandwich_template_matches_reference(spec):
    tpl = _ghz(4).into_sandwich_template(spec)
    ref = _ghz(4, False).into_sandwich_template(spec)
    _same_network(tpl.network, ref.network)
    assert (tpl.num_qubits, tpl.determined, tpl.spec) == (ref.num_qubits, ref.determined,
                                                          ref.spec)
    assert tpl.permutor.target_leg_order == ref.permutor.target_leg_order
    assert (tpl.bra_qubits, tpl.observable_qubits) == (ref.bra_qubits, ref.observable_qubits)
    bits = "01" * 2
    req = bits[:len(tpl.bra_qubits)]
    assert tpl.request_bits(req) == ref.request_bits(req)


def _error(fn):
    with pytest.raises(Exception) as info:
        fn()
    return type(info.value), str(info.value)


@pytest.mark.parametrize("call", [
    lambda c: c.into_sandwich_template("??"),
    lambda c: c.into_sandwich_template("?x*?"),
    lambda c: c.into_sandwich_template("?p**"),
    lambda c: c.into_amplitude_template("01"),
    lambda c: c.into_amplitude_template("01x1"),
    lambda c: c.into_amplitude_template("01*1").request_bits("0101"),
    lambda c: c.into_amplitude_template("01*1").request_bits("01*"),
    lambda c: c.into_amplitude_template("01*1").request_bits("*1*1"),
    lambda c: c.into_sandwich_template("??**").request_bits("0*"),
    lambda c: c.into_sandwich_template("??**").request_bits("011"),
    lambda c: (c.into_sandwich_template("????"), c.copy()),
    lambda c: (c.into_amplitude_template(None), c.into_sandwich_template("????")),
], ids=["spec_length", "spec_char", "spec_mix", "mask_length", "mask_char", "request_open",
        "request_length", "request_determined", "sandwich_wildcard", "sandwich_length",
        "copy_finalized", "second_finalizer"])
def test_template_errors_match_reference(call):
    assert _error(lambda: call(_ghz(4))) == _error(lambda: call(_ghz(4, False)))


def test_copy_is_independent():
    c = _ghz(4)
    dup = c.copy()
    n = len(c.tensor_network.tensors)
    tpl = dup.into_sandwich_template("?*o?")
    assert len(c.tensor_network.tensors) == n and not c._finalized
    ref = _ghz(4, False).copy().into_sandwich_template("?*o?")
    _same_network(tpl.network, ref.network)
    _same_network(c.into_amplitude_template("0101").network,
                  _ghz(4, False).into_amplitude_template("0101").network)


# -- amplitude_sweep -----------------------------------------------------------


@pytest.mark.parametrize("case", list(CASES))
def test_amplitude_sweep_numpy_is_the_references_bits(case):
    n = CASES[case][0]
    bits = _bits(n)
    got = amplitude_sweep(_syc(case), bits, backend=NumpyBackend())
    want = ref_amplitude_sweep(_syc(case, False), bits, backend=RefNumpyBackend())
    assert got.shape == (len(bits),) and got.dtype == want.dtype
    assert np.array_equal(got, want)


@pytest.mark.parametrize("split", [True, False], ids=["split", "native"])
@pytest.mark.parametrize("case", list(CASES))
def test_amplitude_sweep_torch_matches_reference(case, split):
    n = CASES[case][0]
    bits = _bits(n)
    want = ref_amplitude_sweep(_syc(case, False), bits, backend=RefNumpyBackend())
    got = amplitude_sweep(_syc(case), bits, backend=TorchBackend(device="cpu",
                                                                  split_complex=split))
    assert float(np.max(np.abs(got - want))) <= REL * float(np.max(np.abs(want)))


def test_amplitude_sweep_ghz_cases():
    import math

    amps = amplitude_sweep(_ghz(3), ["000", "111", "010"],
                           backend=TorchBackend(device="cpu"))
    assert np.allclose(np.abs(amps), [1 / math.sqrt(2), 1 / math.sqrt(2), 0.0], atol=1e-6)
    assert amplitude_sweep(_ghz(3), []).shape == (0,)
    assert amplitude_sweep(_ghz(3), []).dtype == np.complex128


@pytest.mark.parametrize("bits", [["01", "011"], ["0x1"], ["01*", "0**"]],
                         ids=["length", "char", "masks"])
def test_amplitude_sweep_errors_match_reference(bits):
    got = _error(lambda: amplitude_sweep(_ghz(3), bits, backend=NumpyBackend()))
    want = _error(lambda: ref_amplitude_sweep(_ghz(3, False), bits, backend=RefNumpyBackend()))
    assert got == want


def test_amplitude_sweep_without_backend_is_the_card():
    """``backend=None`` is ``TorchBackend()`` on the card: it raises
    without CUDA rather than running on the host."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        amplitude_sweep(_ghz(3), ["000"])


@pytest.mark.parametrize("entry", ["wildcard_sweep", "amplitudes", "amplitudes_det"])
def test_serving_entry_points_without_backend_are_the_card(entry):
    """With no backend the wildcard branch of ``amplitude_sweep`` and a
    bound program's ``amplitudes`` / ``amplitudes_det`` take
    ``TorchBackend()`` too (the reference takes its complex128
    ``NumpyBackend``): they raise without CUDA."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    bound = bind_template(_ghz(3).into_amplitude_template())
    calls = {
        "wildcard_sweep": lambda: amplitude_sweep(_ghz(3), ["0*0", "1*1"]),
        "amplitudes": lambda: bound.amplitudes(["000"]),
        "amplitudes_det": lambda: bound.amplitudes_det(["000"]),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()


@pytest.mark.parametrize("case", list(CASES))
def test_amplitude_sweep_wildcards_match_reference(case):
    n = CASES[case][0]
    k = n // 2
    patterns = [b[:k] + "*" * (n - k) for b in _bits(n, 5, seed=11)]
    want = ref_amplitude_sweep(_syc(case, False), patterns, backend=RefNumpyBackend())
    got = amplitude_sweep(_syc(case), patterns, backend=NumpyBackend())
    assert got.dtype == want.dtype == np.float64
    assert np.array_equal(got, want)
    got = amplitude_sweep(_syc(case), patterns, backend=TorchBackend(device="cpu"))
    assert float(np.max(np.abs(got - want))) <= REL * float(np.max(want))
    # the reference's first doctest, on the complex128 oracle
    c = Circuit()
    reg = c.allocate_register(2)
    c.append_gate(TensorData.gate("x"), [reg.qubit(0)])
    assert amplitude_sweep(c, ["1*", "0*"], backend=NumpyBackend()).tolist() == [1.0, 0.0]


# -- bind_template / BoundProgram ---------------------------------------------------


@functools.lru_cache(maxsize=None)
def _bound(case, mask=None, target=None):
    """The port's and the reference's bound programs of one template."""
    port = bind_template(_syc(case).into_amplitude_template(mask), target_size=target)
    ref = ref_bind_template(_syc(case, False).into_amplitude_template(mask), target_size=target)
    return port, ref


def _request(tpl, bits):
    return ["".join("*" if m == "*" else c for m, c in zip(tpl.mask, b)) for b in bits]


@pytest.mark.parametrize("case", list(CASES))
def test_bound_plan_matches_reference_and_sweep(case):
    port, ref = _bound(case)
    assert plan_signature(port) == ref.program.signature_digest()
    assert port.bra_slots == ref.bra_slots
    assert (port.batch_flags, port.threadable) == (ref.batch_flags, ref.threadable)
    # the sweep plans the same program for the all-zeros template
    program, _, bras = port_sweep._sweep_program(_syc(case), _bits(CASES[case][0]), None)
    assert program.signature_digest() == plan_signature(port)
    assert tuple(bras) == port.bra_slots


@pytest.mark.parametrize("mask", [None, "01*10*1*0110"], ids=["closed", "open3"])
def test_bound_numpy_is_the_references_bits(mask):
    port, ref = _bound("syc12m4", mask)
    reqs = _request(port.template, _bits(12, 5))
    reset_dispatch()
    got = port.amplitudes(reqs, NumpyBackend())
    want = ref.amplitudes(reqs, RefNumpyBackend())
    assert got.shape == want.shape == (5,) + port.result_shape
    assert np.array_equal(got, want)
    assert DISPATCH == {"threaded": 1}


@pytest.mark.parametrize("b", [3, 5, 8])
@pytest.mark.parametrize("case", list(CASES))
def test_bound_threaded_branch_pads_and_matches_reference(case, b):
    """A native ``TorchBackend`` on a threadable program (the reference's
    threaded branch, padded to a power of two there) runs
    ``execute_batched`` on exactly the B rows asked for, each row equal to
    its bitstring run alone through the same executor."""
    port, ref = _bound(case)
    assert port.threadable
    reqs = _bits(CASES[case][0], b, seed=b)
    want = ref.amplitudes(reqs, RefNumpyBackend())
    backend = TorchBackend(device="cpu", split_complex=False)
    reset_dispatch()
    got = port.amplitudes(reqs, backend)
    again = port.amplitudes(reqs, backend)
    assert DISPATCH == {"batched": 2}
    assert got.shape == (b,)
    assert np.array_equal(got, again)
    assert float(np.max(np.abs(got - want))) <= REL * float(np.max(np.abs(want)))
    alone = np.concatenate([port.amplitudes([r], backend) for r in reqs[-2:]])
    assert float(np.max(np.abs(got[-2:] - alone))) <= REL * float(np.max(np.abs(want)))


@pytest.mark.parametrize("case", list(CASES))
def test_bound_batched_branch_matches_reference_and_sweep(case):
    port, ref = _bound(case)
    n = CASES[case][0]
    reqs = _bits(n)
    want = ref.amplitudes(reqs, RefNumpyBackend())
    backend = TorchBackend(device="cpu", split_complex=True)
    reset_dispatch()
    got = port.amplitudes(reqs, backend)
    assert DISPATCH == {"batched": 1}
    assert float(np.max(np.abs(got - want))) <= REL * float(np.max(np.abs(want)))
    # the same program as the sweep's, so the same bits
    assert np.array_equal(got, amplitude_sweep(_syc(case), reqs, backend=backend))


def test_bound_open_legs_match_reference_on_torch():
    port, ref = _bound("syc12m4", "01*10*1*0110")
    reqs = _request(port.template, _bits(12, 3))
    want = ref.amplitudes(reqs, RefNumpyBackend())
    for split in (True, False):
        got = port.amplitudes(reqs, TorchBackend(device="cpu", split_complex=split))
        assert got.shape == want.shape == (3, 2, 2, 2)
        assert float(np.max(np.abs(got - want))) <= REL * float(np.max(np.abs(want)))


def _sliced(case):
    """Bound under a target a third of the plan's peak: sliced (8 slices
    on syc12m4, 4 on syc16m6)."""
    port, _ = _bound(case)
    from tnc_tpu_torch.contractionpath.paths import Greedy, OptMethod

    peak = Greedy(OptMethod.GREEDY).find_path(port.template.network).size
    return _bound(case, None, float(peak) / 3)


@pytest.mark.parametrize("case", list(CASES))
def test_bound_sliced_branch_matches_reference(case):
    port, ref = _sliced(case)
    assert port.sliced is not None and ref.sliced is not None
    assert port.sliced.slicing.legs == ref.sliced.slicing.legs
    assert port.sliced.program.signature_digest() == ref.sliced.program.signature_digest()
    reqs = _bits(CASES[case][0], 3)
    want = ref.amplitudes(reqs, RefNumpyBackend())
    reset_dispatch()
    got = port.amplitudes(reqs, NumpyBackend())
    assert np.max(np.abs(got - want)) <= 1e-12 * np.max(np.abs(want))
    for split in (True, False):
        got = port.amplitudes(reqs, TorchBackend(device="cpu", split_complex=split))
        assert float(np.max(np.abs(got - want))) <= REL * float(np.max(np.abs(want)))
    assert DISPATCH == {"sliced": 3}


@pytest.mark.parametrize("case", list(CASES))
def test_bound_slice_range_partials_match_reference(case):
    port, ref = _sliced(case)
    n_slices = port.sliced.slicing.num_slices
    reqs = _bits(CASES[case][0], 2)
    batch = [port.template.request_bits(b) for b in reqs]
    half = n_slices // 2
    parts = []
    for rng in ((0, half), (half, n_slices)):
        want = ref.amplitudes_det(batch, RefNumpyBackend(), slice_range=rng)
        got = port.amplitudes_det(batch, NumpyBackend(), slice_range=rng)
        assert np.max(np.abs(got - want)) <= 1e-12 * np.max(np.abs(want))
        got32 = port.amplitudes_det(batch, TorchBackend(device="cpu"), slice_range=rng)
        assert float(np.max(np.abs(got32 - want))) <= REL * float(np.max(np.abs(want)))
        parts.append(got)
    whole = port.amplitudes_det(batch, NumpyBackend())
    assert np.max(np.abs(parts[0] + parts[1] - whole)) <= 1e-12 * np.max(np.abs(whole))
    unsliced, _ = _bound(case)
    with pytest.raises(ValueError, match="slice_range only applies"):
        unsliced.amplitudes_det(batch, NumpyBackend(), slice_range=(0, 1))


def test_bound_fully_open_template_matches_reference():
    port = bind_template(_ghz(3).into_amplitude_template("***"))
    ref = ref_bind_template(_ghz(3, False).into_amplitude_template("***"))
    got = port.amplitudes(["***", "***"], TorchBackend(device="cpu"))
    want = ref.amplitudes(["***", "***"], RefNumpyBackend())
    assert got.shape == want.shape == (2, 2, 2, 2)
    assert float(np.max(np.abs(got - want))) <= REL * float(np.max(np.abs(want)))
    assert port.amplitudes([], NumpyBackend()).shape == ref.amplitudes([]).shape == (0, 2, 2, 2)


def test_unported_serving_options_raise(tmp_path):
    """``plan_cache`` and ``reuse_store`` bind (the same bits as a cold
    binding on numpy); ``fleet_dir`` puts the service on the fleet roster
    until it stops, and the replanner asks for a plan cache as the
    reference's does."""
    from tnc_tpu_torch.serve import ContractionService, IntermediateStore, PlanCache

    reqs = ["000", "111", "010"]
    want = bind_template(_ghz(3).into_amplitude_template()).amplitudes(reqs, NumpyBackend())
    for kw in ({"plan_cache": PlanCache(tmp_path)}, {"reuse_store": IntermediateStore()}):
        got = bind_template(_ghz(3).into_amplitude_template(), **kw)
        assert got.amplitudes(reqs, NumpyBackend()).tobytes() == want.tobytes()
        got = bind_circuit(_ghz(3), **kw)
        assert got.amplitudes(reqs, NumpyBackend()).tobytes() == want.tobytes()
    from tnc_tpu_torch.obs.fleet import FleetRegistry

    fleet = tmp_path / "fleet"
    with ContractionService.from_circuit(_ghz(3), backend=NumpyBackend(),
                                         fleet_dir=str(fleet)) as svc:
        assert svc.amplitude("111") == pytest.approx(2 ** -0.5)
        assert [r["name"] for r in svc.fleet_snapshot()["roster"]["replicas"]] == ["p0"]
    assert FleetRegistry(fleet).roster()["replicas"] == []  # a clean leave
    with pytest.raises(ValueError, match="requires a plan_cache"):
        ContractionService.from_circuit(_ghz(3), backend=NumpyBackend(),
                                        background_replan=True)


def test_generic_backend_loops():
    class Plain:
        def execute(self, program, arrays):
            return NumpyBackend().execute(program, arrays)

    port, ref = _bound("syc12m4")
    reqs = _bits(12, 3)
    reset_dispatch()
    got = port.amplitudes(reqs, Plain())
    assert DISPATCH == {"loop": 1}
    want = ref.amplitudes(reqs, RefNumpyBackend())
    assert np.array_equal(got, want)
    # amplitude_sweep runs one execute per bitstring on such a backend
    assert np.array_equal(amplitude_sweep(_syc("syc12m4"), reqs, backend=Plain()), want)
