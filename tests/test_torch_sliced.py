"""Sliced execution of the port against the JAX package, on the CPU.

The network (``sycamore_circuit`` + ``simplify_network``), the plan
(``Greedy`` + ``find_slicing``), the sliced program and the sliced result
of ``tnc_tpu_torch`` are held to ``tnc_tpu``'s on the same seeds:

- leaves, paths, slicings and program shapes exactly;
- ``TorchBackend(device="cpu", split_complex=True)`` (float32 parts) on
  its per-slice loop (``sliced_strategy="loop", hoist=False``: the
  hoisted, chunked default is held to the reference in
  ``test_torch_chunked.py``) against the reference's ``JaxBackend`` slice
  loop (Pallas in interpret mode) and its complex128 ``NumpyBackend``
  within 1e-5 relative — two float32 executions of one plan against each
  other and against complex128, summed over the slices with Kahan
  compensation;
- the same backend with float64 parts against the port's complex128 numpy
  oracle within 1e-12 relative, and that oracle against the reference's.

Configurations: ``sycamore_circuit(20, 6, rng 7)`` sliced to 2^7 (4
slices, 2 chains) and ``sycamore_circuit(20, 8, rng 7)`` sliced to 2^17
(16 slices); the plan-level checks also take the 53-qubit depth-10
network sliced to 2^29 (128 slices), the cell ``chip_smoke.py`` runs on
the card.
"""

import doctest
import functools

import numpy as np
import pytest
import torch

import tnc_tpu.contractionpath.slicing as ref_slicing
import tnc_tpu.ops.split_complex as ref_split
import tnc_tpu_torch.ops.cuda_complex as port_cuda
import tnc_tpu_torch.ops.sliced as port_sliced
import tnc_tpu_torch.ops.split_complex as port_split
from tnc_tpu.builders import connectivity as ref_connectivity
from tnc_tpu.builders.sycamore_circuit import sycamore_circuit as ref_sycamore
from tnc_tpu.ops.backends import JaxBackend
from tnc_tpu.ops.backends import NumpyBackend as RefNumpyBackend
from tnc_tpu.ops.hoist import hoist_sliced_program
from tnc_tpu.partitioning.native_binding import SlicedReplayer
from tnc_tpu.tensornetwork.contraction import (
    contract_tensor_network_sliced as ref_contract_sliced,
)
from tnc_tpu.tensornetwork.simplify import simplify_network as ref_simplify
from tnc_tpu_torch.builders import connectivity
from tnc_tpu_torch.builders.sycamore_circuit import sycamore_circuit
from tnc_tpu_torch.contractionpath import slicing
from tnc_tpu_torch.ops.backends import NumpyBackend, TorchBackend, run_steps_timed
from tnc_tpu_torch.ops.chunked import slice_index_rows
from tnc_tpu_torch.ops.program import step_flops
from tnc_tpu_torch.ops.sliced import build_sliced_program, execute_sliced_numpy, kahan_add
from tnc_tpu_torch.tensornetwork.contraction import (
    contract_tensor_network,
    contract_tensor_network_sliced,
)
from tnc_tpu_torch.tensornetwork.simplify import simplify_network
from tests._torch_sliced_cases import CELL, SIXTEEN, SMALL, _both, _ids, _scalar

EXECUTED = [SMALL, SIXTEEN]
PLANNED = [SMALL, SIXTEEN, CELL]


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


# -- builders and simplification ---------------------------------------------


def test_sycamore_patterns_match_reference():
    for name in ("sycamore_a", "sycamore_b", "sycamore_c", "sycamore_d"):
        assert getattr(connectivity, name)() == getattr(ref_connectivity, name)()


@pytest.mark.parametrize("cfg", [SMALL, CELL], ids=_ids([SMALL, CELL]))
def test_network_leaves_match_reference(cfg):
    q, m, seed, _ = cfg
    port, _ = sycamore_circuit(q, m, np.random.default_rng(seed)).into_amplitude_network("0" * q)
    ref, _ = ref_sycamore(q, m, np.random.default_rng(seed)).into_amplitude_network("0" * q)
    assert len(port.tensors) == len(ref.tensors)
    port, ref = simplify_network(port), ref_simplify(ref)
    assert len(port.tensors) == len(ref.tensors) < q * (m + 2)
    for a, b in zip(port.tensors, ref.tensors):
        assert a.legs == b.legs and list(a.bond_dims) == list(b.bond_dims)
        assert np.array_equal(a.data.into_data(), b.data.into_data())


def test_sycamore_circuit_rejects_too_many_qubits():
    with pytest.raises(ValueError, match="53-qubit"):
        sycamore_circuit(54, 1)


# -- planning ----------------------------------------------------------------


@pytest.mark.parametrize("cfg", PLANNED, ids=_ids(PLANNED))
def test_slicing_matches_reference(cfg):
    both = _both(cfg)
    port, ref = both["port"], both["ref"]
    assert port["path"].toplevel == ref["path"].toplevel
    assert port["slicing"].legs == ref["slicing"].legs
    assert port["slicing"].dims == ref["slicing"].dims
    args = (port["tn"].tensors, port["path"].toplevel, port["slicing"])
    ref_args = (ref["tn"].tensors, ref["path"].toplevel, ref["slicing"])
    assert slicing.sliced_flops(*args) == ref_slicing.sliced_flops(*ref_args)
    assert slicing.sliced_peak(*args) == ref_slicing.sliced_peak(*ref_args)
    assert slicing.sliced_peak(*args) <= 2.0 ** cfg[3]


def test_python_replay_matches_native_replay_on_the_cell():
    """The reference slices the 53-qubit plan with its native replayer; the
    port's Python replay picks the same legs and reports the same sizes
    and per-slice cost."""
    ref = _both(CELL)["ref"]
    replayer = ref_slicing._make_replayer(ref["tn"].tensors, ref["path"].toplevel)
    assert isinstance(replayer, SlicedReplayer) and replayer.available
    port = _both(CELL)["port"]
    py = slicing._make_replayer(port["tn"].tensors, port["path"].toplevel)
    removed = set()
    for leg in port["slicing"].legs:
        removed.add(leg)
        peak, leg_peak = py.sizes(removed)
        native_peak, native_leg_peak = replayer.sizes(removed)
        assert peak == native_peak and leg_peak == native_leg_peak
        assert py.flops(removed) == replayer.flops(removed)


def test_cell_plan_numbers(monkeypatch):
    """The 53-qubit depth-10 cell: 128 slices of 169 steps, the default
    policy's 4 chains and one Strassen step, the same policy as the
    reference's, and the forced fused rung's gate (11 steps admitted)."""
    both = _both(CELL)
    sp = both["port"]["sp"]
    assert sp.slicing.num_slices == 128 and len(sp.program.steps) == 169
    monkeypatch.delenv("TNC_TPU_COMPLEX_MULT", raising=False)
    policy = port_split.plan_kernels(sp.program)
    ref_policy = ref_split.plan_kernels(both["ref"]["sp"].program)
    assert policy.modes == ref_policy.modes and policy.chains == ref_policy.chains
    assert policy.chains == ((9, 11), (23, 25), (27, 29), (34, 36))
    assert policy.modes.count("strassen") == 1 and policy.modes.count("gauss") == 160
    fused = sum(
        st.a_cfirst and st.b_cfirst and port_cuda.eligible(*_kmn(st)) for st in sp.program.steps
    )
    assert fused == 11


def _kmn(st):
    from tnc_tpu_torch.ops.program import step_dims

    m, k, n = step_dims(st)
    return (k, n, m) if st.swap else (k, m, n)


def test_hoisting_the_cell_leaves_no_chain():
    """Why the cell's loop runs unhoisted to measure the chain kernel: the
    reference's hoist pass puts 128 of its 169 steps, all four chains among
    them, into the prelude, and the 41 residual steps form no chain."""
    hp = hoist_sliced_program(_both(CELL)["ref"]["sp"])
    assert len(hp.prelude_steps) == 128 and len(hp.residual.program.steps) == 41
    assert ref_split.plan_kernels(hp.residual.program).chains == ()


@pytest.mark.parametrize("cfg", EXECUTED, ids=_ids(EXECUTED))
def test_sliced_program_matches_reference(cfg):
    both = _both(cfg)
    port, ref = both["port"]["sp"], both["ref"]["sp"]
    assert port.slot_slices == ref.slot_slices
    fields = ("lhs", "rhs", "a_view", "a_perm", "a_dot", "a_cfirst", "b_view",
              "b_perm", "b_dot", "b_cfirst", "swap", "out_store")
    for a, b in zip(port.program.steps, ref.program.steps, strict=True):
        assert all(getattr(a, f) == getattr(b, f) for f in fields)
    assert port.program.result_shape == ref.program.result_shape
    assert port.program.stored_result_shape == ref.program.stored_result_shape


# -- execution ---------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _reference_results(cfg):
    ref = _both(cfg)["ref"]
    jax_out = JaxBackend(split_complex=True, sliced_strategy="loop", hoist=False
                         ).execute_sliced(ref["sp"], ref["arrays"])
    numpy_out = RefNumpyBackend().execute_sliced(ref["sp"], ref["arrays"])
    return _scalar(jax_out), _scalar(numpy_out)


def _loop_backend(**kw):
    """The per-slice loop, unhoisted: what these tests hold to the
    reference's ``JaxBackend`` loop."""
    return TorchBackend(device="cpu", sliced_strategy="loop", hoist=False, **kw)


def _port_split(cfg, dtype="complex64", **kw):
    port = _both(cfg)["port"]
    return _loop_backend(dtype=dtype, split_complex=True).execute_sliced(
        port["sp"], port["arrays"], **kw)


@pytest.mark.parametrize("cfg", EXECUTED, ids=_ids(EXECUTED))
def test_split_float32_matches_jax_slice_loop(cfg):
    jax_amp, _ = _reference_results(cfg)
    got = _scalar(_port_split(cfg))
    assert abs(got - jax_amp) <= 1e-5 * abs(jax_amp)


@pytest.mark.parametrize("cfg", EXECUTED, ids=_ids(EXECUTED))
def test_split_float32_matches_reference_numpy(cfg):
    _, want = _reference_results(cfg)
    got = _scalar(_port_split(cfg))
    assert abs(got - want) <= 1e-5 * abs(want)


@pytest.mark.parametrize("cfg", EXECUTED, ids=_ids(EXECUTED))
def test_split_float64_matches_port_oracle(cfg):
    port = _both(cfg)["port"]
    want = _scalar(NumpyBackend().execute_sliced(port["sp"], port["arrays"]))
    got = _scalar(_port_split(cfg, dtype="complex128"))
    assert abs(got - want) <= 1e-12 * abs(want)


@pytest.mark.parametrize("cfg", EXECUTED, ids=_ids(EXECUTED))
def test_port_oracle_matches_reference_oracle(cfg):
    port = _both(cfg)["port"]
    _, want = _reference_results(cfg)
    got = _scalar(execute_sliced_numpy(port["sp"], port["arrays"]))
    assert abs(got - want) <= 1e-12 * abs(want)


def test_native_complex_slices_match_port_oracle():
    port = _both(SMALL)["port"]
    want = _scalar(NumpyBackend().execute_sliced(port["sp"], port["arrays"]))
    got = _scalar(_loop_backend(dtype="complex128", split_complex=False)
                  .execute_sliced(port["sp"], port["arrays"]))
    assert abs(got - want) <= 1e-12 * abs(want)


def test_every_slice_runs_each_chain_and_one_policy(monkeypatch):
    """4 slices x 2 chains: the chain wrapper is called 8 times, and the
    kernel policy is planned once for the whole loop."""
    calls = {"chain": 0, "plan": 0}
    chain, plan = port_cuda.fused_chain, port_split.plan_kernels

    def counting_chain(*args):
        calls["chain"] += 1
        return chain(*args)

    def counting_plan(*args, **kw):
        calls["plan"] += 1
        return plan(*args, **kw)

    monkeypatch.setattr(port_cuda, "fused_chain", counting_chain)
    monkeypatch.setattr(port_split, "plan_kernels", counting_plan)
    monkeypatch.delenv("TNC_TPU_COMPLEX_MULT", raising=False)
    _port_split(SMALL)
    assert calls == {"chain": 8, "plan": 1}


def test_resident_leaves_survive_the_loop():
    """Each slice frees its own buffers; the full leaves the loop indexes
    stay intact, so the same resident leaves serve every slice."""
    backend = _loop_backend(split_complex=True)
    port = _both(SMALL)["port"]
    full = backend._device_buffers(port["arrays"])
    before = [tuple(p.clone() for p in pair) for pair in full]
    first = backend._run_sliced(port["sp"], full, 0, 4)
    second = backend._run_sliced(port["sp"], full, 0, 4)
    for pair, kept in zip(full, before):
        assert all(torch.equal(p, k) for p, k in zip(pair, kept))
    assert all(torch.equal(a, b) for a, b in zip(first, second))


# -- the execute_sliced contract ----------------------------------------------


@pytest.mark.parametrize("kw", [{"max_slices": 2}, {"max_slices": 99},
                                {"slice_range": (1, 3)}, {"slice_range": (3, 9)},
                                {"slice_range": (2, 2)}],
                         ids=["max2", "max99", "range1-3", "range3-9", "empty"])
def test_partial_sums_follow_reference(kw):
    port, ref = _both(SMALL)["port"], _both(SMALL)["ref"]
    want = np.asarray(RefNumpyBackend().execute_sliced(ref["sp"], ref["arrays"], **kw))
    oracle = np.asarray(NumpyBackend().execute_sliced(port["sp"], port["arrays"], **kw))
    got = np.asarray(_port_split(SMALL, **kw))
    scale = max(float(np.max(np.abs(want))), 1e-30)
    assert np.max(np.abs(oracle - want)) <= 1e-12 * scale
    assert np.max(np.abs(got - want)) <= 1e-5 * scale


def test_max_slices_and_slice_range_exclude_each_other():
    port, ref = _both(SMALL)["port"], _both(SMALL)["ref"]
    kw = {"max_slices": 2, "slice_range": (0, 2)}
    with pytest.raises(ValueError):
        RefNumpyBackend().execute_sliced(ref["sp"], ref["arrays"], **kw)
    for backend in (NumpyBackend(), _loop_backend(split_complex=True),
                    TorchBackend(device="cpu", split_complex=True)):
        with pytest.raises(ValueError, match="exclusive"):
            backend.execute_sliced(port["sp"], port["arrays"], **kw)


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_hoist_matches_unhoisted(backend):
    """``hoist=True`` (the stem once, then the residual per slice) gives the
    unhoisted loop's sum, on the numpy oracle (whose default stays off) and
    on the device loop (whose ``None`` takes the backend's setting)."""
    port = _both(SMALL)["port"]
    obj = NumpyBackend() if backend == "numpy" else _loop_backend()
    unhoisted = _scalar(obj.execute_sliced(port["sp"], port["arrays"], hoist=False))
    hoisted = _scalar(obj.execute_sliced(port["sp"], port["arrays"], hoist=True))
    assert abs(hoisted - unhoisted) <= 1e-12 * abs(unhoisted)
    assert _scalar(obj.execute_sliced(port["sp"], port["arrays"], hoist=None)) == unhoisted


def test_host_false_keeps_stored_shape_with_open_legs():
    """Two qubits left open: the device result comes back as a (re, im)
    pair in the program's stored shape, the host result in its result
    shape; both equal the reference's."""
    q = SMALL[0]
    both = _both(SMALL, "0" * (q - 2) + "**")
    port, ref = both["port"], both["ref"]
    assert port["sp"].slicing.num_slices > 1
    ref_dev = JaxBackend(split_complex=True, sliced_strategy="loop", hoist=False
                         ).execute_sliced(ref["sp"], ref["arrays"], host=False)
    re, im = _loop_backend(split_complex=True).execute_sliced(
        port["sp"], port["arrays"], host=False)
    stored = port["sp"].program.stored_result_shape
    assert tuple(re.shape) == tuple(im.shape) == stored == tuple(ref_dev[0].shape)
    assert NumpyBackend().execute_sliced(port["sp"], port["arrays"], host=False).shape == stored
    host = _loop_backend(split_complex=True).execute_sliced(port["sp"], port["arrays"])
    want = RefNumpyBackend().execute_sliced(ref["sp"], ref["arrays"])
    assert host.shape == want.shape == port["sp"].program.result_shape
    assert _rel(host, want) <= 1e-5


def test_sliced_entry_point_matches_reference_with_open_legs():
    q = SMALL[0]
    both = _both(SMALL, "0" * (q - 2) + "**")
    port, ref = both["port"], both["ref"]
    got = contract_tensor_network_sliced(port["tn"], port["path"], port["slicing"],
                                         TorchBackend(device="cpu", split_complex=True))
    want = ref_contract_sliced(ref["tn"], ref["path"], ref["slicing"], RefNumpyBackend())
    assert got.legs == want.legs and list(got.bond_dims) == list(want.bond_dims)
    assert _rel(got.data.into_data(), want.data.into_data()) <= 1e-5
    oracle = contract_tensor_network_sliced(port["tn"], port["path"], port["slicing"], "numpy")
    assert _rel(oracle.data.into_data(), want.data.into_data()) <= 1e-12


def test_one_slice_runs_the_plain_program():
    port = _both(SMALL)["port"]
    none = slicing.Slicing((), ())
    sp = build_sliced_program(port["tn"], port["path"], none)
    backend = TorchBackend(device="cpu", split_complex=True)
    got = _scalar(backend.execute_sliced(sp, port["arrays"]))
    want = _scalar(contract_tensor_network(port["tn"], port["path"], backend).data.into_data())
    assert got == want
    re, im = backend.execute_sliced(sp, port["arrays"], host=False)
    assert tuple(re.shape) == sp.program.stored_result_shape
    whole = _scalar(NumpyBackend().execute_sliced(_both(SMALL)["port"]["sp"], port["arrays"]))
    assert abs(got - whole) <= 1e-5 * abs(whole)


def test_entry_point_needs_cuda_without_a_backend():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default backend runs on it")
    port = _both(SMALL)["port"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        contract_tensor_network_sliced(port["tn"], port["path"], port["slicing"])


# -- accumulation and per-step records ----------------------------------------


def test_kahan_add_keeps_the_reference_doctest():
    finder = doctest.DocTestFinder()
    runner = doctest.DocTestRunner()
    for test in finder.find(port_sliced.kahan_add, "kahan_add", globs=dict(vars(port_sliced))):
        runner.run(test)
    assert runner.failures == 0 and runner.tries >= 3


def test_kahan_add_on_tensors_keeps_small_terms():
    s, c = torch.tensor(1.0), torch.tensor(0.0)
    plain = torch.tensor(1.0)
    for _ in range(100):
        s, c = kahan_add(s, c, torch.tensor(1e-8))
        plain = plain + torch.tensor(1e-8)
    assert float(plain) == 1.0
    assert 9e-7 < float(s + c) - 1.0 < 1.1e-6


def test_module_doctests():
    for module in (port_sliced, slicing):
        assert doctest.testmod(module).failed == 0


def test_run_steps_timed_records(monkeypatch):
    """One record per launch unit (step or chain), labelled and costed,
    with wall milliseconds on the CPU; the result equals the untimed run."""
    monkeypatch.delenv("TNC_TPU_COMPLEX_MULT", raising=False)
    port = _both(SMALL)["port"]
    sp = port["sp"]
    backend = TorchBackend(device="cpu", split_complex=True)
    policy = backend.kernel_policy(sp.program)
    row = torch.from_numpy(slice_index_rows(sp.slicing, 0, 1))
    buffers = backend.slice_buffers(sp, backend._device_buffers(port["arrays"]), row)
    out, records = run_steps_timed(sp.program, list(buffers), policy)
    want = port_split.run_steps_split(sp.program, list(buffers), policy=policy)
    assert all(torch.equal(a, b) for a, b in zip(out, want))
    assert len(records) == policy.dispatch_count()
    chains = [r for r in records if r["mode"] == "chain"]
    assert [r["label"] for r in chains] == [
        f"step[{s}..{e - 1}] chain x{e - s}" for s, e in policy.chains]
    assert records[0]["label"].startswith("step[0] ") and "·" in records[0]["label"]
    assert sum(r["flops"] for r in records) == sum(step_flops(st) for st in sp.program.steps)
    assert all(r["ms"] >= 0.0 and r["host_ms"] >= 0.0 and r["bytes_in"] > 0
               and r["bytes_out"] > 0 for r in records)
    assert {r["mode"] for r in records} <= {"chain", "gauss", "strassen"}


def test_run_steps_timed_bytes_follow_the_buffers(monkeypatch):
    """Bytes are counted at the buffers' own width: float64 parts give
    twice float32's; the hook of ``run_steps_split`` sees each launch unit
    once, in order, and the run's result is unchanged by it."""
    monkeypatch.delenv("TNC_TPU_COMPLEX_MULT", raising=False)
    port = _both(SMALL)["port"]
    sp = port["sp"]
    backend = TorchBackend(device="cpu", split_complex=True)
    policy = backend.kernel_policy(sp.program)
    row = torch.from_numpy(slice_index_rows(sp.slicing, 0, 1))
    buffers = backend.slice_buffers(sp, backend._device_buffers(port["arrays"]), row)
    wide = [None if b is None else tuple(x.double() for x in b) for b in buffers]
    _, narrow_records = run_steps_timed(sp.program, list(buffers), policy)
    _, wide_records = run_steps_timed(sp.program, list(wide), policy)
    for n, w in zip(narrow_records, wide_records, strict=True):
        assert (w["bytes_in"], w["bytes_out"]) == (2 * n["bytes_in"], 2 * n["bytes_out"])
    units = []
    out = port_split.run_steps_split(
        sp.program, list(buffers), policy=policy,
        on_unit=lambda start, end, run: (units.append((start, end)), run()))
    want = port_split.run_steps_split(sp.program, list(buffers), policy=policy)
    assert all(torch.equal(a, b) for a, b in zip(out, want))
    assert units[0][0] == 0 and units[-1][1] == len(sp.program.steps)
    assert all(a[1] == b[0] for a, b in zip(units, units[1:]))
    assert [u for u in units if u[1] - u[0] > 1] == list(policy.chains)

