"""The port's examples (``tnc_tpu_torch/examples/``) against the reference.

Each example's ``main()`` runs under the host pin (``TNC_TPU_PLATFORM=cpu``
through ``logging_config._PINNED``) with the reference's sizes and seeds,
and each value it returns is held against the same computation through the
reference package in this process: its library functions on the same numpy
inputs, and its complex128 numpy oracle. The reference's example scripts
themselves are not run here (one of them sets JAX's x64 flag for the whole
process).

Also: the benchmark CLI's ``do_run(..., distributed=True)`` on a
2-partition scenario, one device slot a partition.
"""

import importlib
import logging
import random

import numpy as np
import pytest

import tnc_tpu_torch.ops.backends as port_backends
import tnc_tpu_torch.parallel as port_parallel
from tnc_tpu_torch.utils import logging_config

EXAMPLES = ("local_contraction", "amplitude_sweep", "autodiff_gradients", "approximate_peps",
            "repartitioning", "distributed_contraction", "sliced_partitioning",
            "strategy_selection")


@pytest.fixture
def host(monkeypatch):
    """The host pin, as ``TNC_TPU_PLATFORM=cpu`` sets it (restored after
    the test), and the annealer's chains without a spawn pool."""
    monkeypatch.setattr(logging_config, "_PINNED", "cpu")
    monkeypatch.setattr(port_backends, "_BACKENDS", {})  # no pinned backend outlives the test
    monkeypatch.setenv("TNC_TPU_SA_WORKERS", "1")


def amplitude_close(got, want, rel=1e-4):
    """The amplitudes rule: within ``rel``·max(|ref|, 2^-14) of complex128."""
    got, want = np.asarray(got), np.asarray(want)
    return bool(np.all(np.abs(got - want) <= rel * np.maximum(np.abs(want), 2.0 ** -14)))


def _ref_value(leaf) -> complex:
    return complex(np.asarray(leaf.data.into_data()).reshape(-1)[0])


def check_local_contraction(out):
    from tnc_tpu.contractionpath.paths import Greedy, OptMethod
    from tnc_tpu.io.qasm import import_qasm
    from tnc_tpu.tensornetwork.contraction import contract_tensor_network
    from tnc_tpu_torch.examples.local_contraction import QASM

    tn, permutor = import_qasm(QASM).into_statevector_network()
    result = Greedy(OptMethod.GREEDY).find_path(tn)
    final = permutor.apply(contract_tensor_network(tn, result.replace_path(), backend="numpy"))
    want = np.asarray(final.data.into_data()).reshape(-1)
    assert (out["flops"], out["size"]) == (result.flops, result.size)
    assert np.max(np.abs(out["statevector"] - want)) <= 1e-5
    assert abs(abs(out["statevector"][0]) - 2 ** -0.5) <= 1e-5


def check_amplitude_sweep(out):
    from tnc_tpu.builders.connectivity import ConnectivityLayout
    from tnc_tpu.builders.random_circuit import random_open_circuit
    from tnc_tpu.ops.backends import NumpyBackend
    from tnc_tpu.tensornetwork import amplitude_sweep

    circuit = random_open_circuit(16, 10, 0.4, 0.4, np.random.default_rng(7),
                                  ConnectivityLayout.LINE)
    sample = np.random.default_rng(0)
    bits = ["".join(sample.choice(["0", "1"]) for _ in range(16)) for _ in range(32)]
    want = amplitude_sweep(circuit, bits, backend=NumpyBackend())
    assert out["bitstrings"] == bits
    assert amplitude_close(out["amplitudes"], want)
    assert out["probability_sum"] == pytest.approx(float(np.sum(np.abs(want) ** 2)), rel=1e-4)


def check_autodiff_gradients(out):
    from tnc_tpu.builders.circuit_builder import Circuit
    from tnc_tpu.contractionpath.paths import Greedy, OptMethod
    from tnc_tpu.ops.autodiff import contraction_value_and_grad
    from tnc_tpu.ops.program import flat_leaf_tensors
    from tnc_tpu.tensornetwork.sweep import amplitude_sweep_value_and_grad
    from tnc_tpu.tensornetwork.tensordata import DataKind, TensorData
    from tnc_tpu_torch.examples.autodiff_gradients import BITSTRINGS, THETA

    c = Circuit()
    reg = c.allocate_register(1)
    c.append_gate(TensorData.gate("rx", [THETA]), [reg.qubit(0)])
    tn = c.into_expectation_value_network()
    path = Greedy(OptMethod.GREEDY).find_path(tn).replace_path()
    slots = [i for i, leaf in enumerate(flat_leaf_tensors(tn))
             if leaf.data.kind is DataKind.GATE and leaf.data.payload[0] == "rx"]
    value, grads = contraction_value_and_grad(tn, path, wrt=slots, dtype="complex128")
    assert out["slots"] == slots
    assert out["z"] == pytest.approx(float(np.asarray(value).reshape(-1)[0].real), abs=1e-12)
    for got, want in zip(out["grads"], grads):
        assert np.allclose(got, np.asarray(want), rtol=0, atol=1e-12)
    assert out["dz_dtheta"] == pytest.approx(-np.sin(THETA), abs=1e-5)

    c2 = Circuit()
    reg2 = c2.allocate_register(3)
    c2.append_gate(TensorData.gate("h"), [reg2.qubit(0)])
    c2.append_gate(TensorData.gate("cx"), [reg2.qubit(0), reg2.qubit(1)])
    c2.append_gate(TensorData.gate("ry", [0.3]), [reg2.qubit(2)])
    amps, sweep_grads = amplitude_sweep_value_and_grad(c2, BITSTRINGS, dtype="complex128")
    assert np.allclose(out["sweep_amplitudes"], np.asarray(amps), rtol=0, atol=1e-12)
    assert len(out["sweep_grads"]) == len(sweep_grads)
    for got, want in zip(out["sweep_grads"], sweep_grads):
        assert np.allclose(got, np.asarray(want), rtol=0, atol=1e-12)


def check_approximate_peps(out):
    from tnc_tpu.approx import ApproxProgram, ChiLadder
    from tnc_tpu.builders.peps import peps
    from tnc_tpu.builders.random_circuit import brickwork_circuit
    from tnc_tpu.contractionpath.paths import Greedy, OptMethod
    from tnc_tpu.ops.backends import NumpyBackend
    from tnc_tpu.tensornetwork.approximate import (
        attach_random_data,
        boundary_mps_contract,
        collapse_peps_sandwich,
    )
    from tnc_tpu.tensornetwork.contraction import contract_tensor_network
    from tnc_tpu.tensornetwork.sweep import amplitude_sweep
    from tnc_tpu_torch.examples.approximate_peps import CHIS, DEPTH, LAYERS, LENGTH

    tn = attach_random_data(peps(LENGTH, DEPTH, 2, 2, LAYERS), np.random.default_rng(11))
    path = Greedy(OptMethod.GREEDY).find_path(tn).replace_path()
    exact = _ref_value(contract_tensor_network(tn, path, backend="numpy"))
    assert out["exact"] == pytest.approx(exact, rel=1e-12)
    grid = collapse_peps_sandwich(tn, LENGTH, DEPTH, LAYERS)
    for chi in CHIS:
        want = boundary_mps_contract(grid, chi=chi)
        assert abs(out["sweep"][chi] - want) <= 1e-8 * abs(exact), chi
    program = ApproxProgram.from_peps_sandwich(tn, LENGTH, DEPTH, LAYERS)
    res = ChiLadder(chi_cap=64).run(program, rtol=1e-6, scale=abs(exact))
    ladder = out["ladder"]
    assert (ladder["chi_used"], ladder["sweeps"], ladder["converged"]) == (
        res.chi_used, res.sweeps, res.converged)
    assert abs(ladder["value"] - res.value) <= 1e-8 * abs(exact)
    assert ladder["err"] >= ladder["true_err"]
    # the service's tolerant answer against the complex128 amplitude
    want = complex(amplitude_sweep(brickwork_circuit(8, 5, np.random.default_rng(0)),
                                   ["10100110"], backend=NumpyBackend())[0])
    served = out["service"]
    assert abs(served["value"] - want) <= 1e-2 * abs(want)
    assert served["approx_completed"] == 1 and not served["escalated"]


def check_repartitioning(out):
    from tnc_tpu.builders.connectivity import ConnectivityLayout
    from tnc_tpu.builders.random_circuit import random_circuit
    from tnc_tpu.contractionpath.repartitioning import compute_solution
    from tnc_tpu.tensornetwork.partitioning import find_partitioning

    tn = random_circuit(16, 8, 0.9, 0.8, np.random.default_rng(7), ConnectivityLayout.LINE)
    initial = find_partitioning(tn, 4)
    _, _, parallel0, serial0 = compute_solution(tn, initial)
    assert out["initial"] == list(initial)
    assert (out["parallel0"], out["serial0"]) == (parallel0, serial0)
    # the annealing is time-bounded: its result is no worse than its start,
    # and the port's own solution of it is what the reference computes
    assert out["parallel1"] <= out["parallel0"]
    _, _, parallel1, serial1 = compute_solution(tn, out["annealed"])
    assert (out["parallel1"], out["serial1"]) == (parallel1, serial1)


def check_distributed_contraction(out):
    from tnc_tpu.builders.sycamore_circuit import sycamore_circuit
    from tnc_tpu.contractionpath.paths import Greedy, OptMethod
    from tnc_tpu.tensornetwork.contraction import contract_tensor_network
    from tnc_tpu.tensornetwork.partitioning import find_partitioning

    tn, _ = sycamore_circuit(12, 8, np.random.default_rng(42)).into_amplitude_network("0" * 12)
    assert out["partitioning"] == list(find_partitioning(tn, 4))
    assert out["blocks"] == 4
    flat = Greedy(OptMethod.GREEDY).find_path(tn).replace_path()
    want = _ref_value(contract_tensor_network(tn, flat, backend="numpy"))
    assert out["oracle"] == pytest.approx(want, rel=1e-12)
    assert amplitude_close(out["amplitude"], want)


def check_sliced_partitioning(out):
    from tnc_tpu.builders.sycamore_circuit import sycamore_circuit
    from tnc_tpu.contractionpath.paths import Greedy, OptMethod
    from tnc_tpu.contractionpath.repartitioning import compute_solution
    from tnc_tpu.tensornetwork.contraction import contract_tensor_network
    from tnc_tpu.tensornetwork.partitioning import find_partitioning
    from tnc_tpu.tensornetwork.simplify import simplify_network

    raw, _ = sycamore_circuit(16, 8, np.random.default_rng(7)).into_amplitude_network("0" * 16)
    tn = simplify_network(raw)
    partitioning = find_partitioning(tn, 4)
    _, _, parallel, serial = compute_solution(tn, partitioning, rng=random.Random(7))
    assert out["partitioning"] == list(partitioning)
    assert (out["parallel_cost"], out["serial_cost"]) == (parallel, serial)
    flat = Greedy(OptMethod.GREEDY).find_path(tn).replace_path()
    want = _ref_value(contract_tensor_network(tn, flat, backend="numpy"))
    assert out["num_slices"] > 1
    assert amplitude_close(out["amplitude"], want)


def check_strategy_selection(out):
    from tnc_tpu.builders.connectivity import ConnectivityLayout
    from tnc_tpu.builders.random_circuit import random_circuit
    from tnc_tpu.contractionpath.communication_schemes import CommunicationScheme
    from tnc_tpu.contractionpath.paths import Greedy, OptMethod
    from tnc_tpu.contractionpath.repartitioning import (
        compute_solution,
        compute_solution_with_paths,
    )
    from tnc_tpu.contractionpath.slicing import find_parallel_slicing, sliced_flops
    from tnc_tpu.contractionpath.treecut import plan_treecut
    from tnc_tpu.tensornetwork.contraction import contract_tensor_network
    from tnc_tpu.tensornetwork.partitioning import find_partitioning
    from tnc_tpu.tensornetwork.simplify import simplify_network

    tn = simplify_network(random_circuit(18, 12, 0.5, 0.5, np.random.default_rng(7),
                                         ConnectivityLayout.SYCAMORE, bitstring="0" * 18))
    serial = Greedy(OptMethod.GREEDY).find_path(tn)
    assert out["serial_flops"] == serial.flops
    _, _, par1, ser1 = compute_solution(tn, find_partitioning(tn, 8), rng=random.Random(0))
    assert out["partitioned"] == (par1, ser1)
    tc = plan_treecut(list(tn.tensors), serial.ssa_path.toplevel, 8, steps=2000)
    _, _, par2, ser2 = compute_solution_with_paths(
        tn, tc.assignment, tc.local_paths,
        communication_scheme=CommunicationScheme.WEIGHTED_BRANCH_BOUND, rng=random.Random(0))
    assert out["treecut"] == (par2, ser2)
    replace = serial.replace_path()
    psl = find_parallel_slicing(list(tn.tensors), replace.toplevel, 8)
    assert out["num_slices"] == psl.num_slices
    assert out["sliced_flops"] == sliced_flops(list(tn.tensors), replace.toplevel, psl)
    want = _ref_value(contract_tensor_network(tn, replace, backend="numpy"))
    assert amplitude_close(out["amplitude"], want)


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_matches_the_reference(name, host, capsys):
    module = importlib.import_module(f"tnc_tpu_torch.examples.{name}")
    out = module.main()
    assert capsys.readouterr().out.strip(), f"{name} printed nothing"
    globals()[f"check_{name}"](out)


def test_examples_import_neither_jax_nor_the_reference():
    import ast
    from pathlib import Path

    folder = Path(__file__).resolve().parent.parent / "tnc_tpu_torch" / "examples"
    for path in sorted(folder.glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for module in names:
                top = module.split(".")[0]
                assert top not in ("jax", "tnc_tpu", "lark"), f"{path.name} imports {module}"
        text = path.read_text()
        assert "_PINNED" not in text and "os.environ" not in text, f"{path.name} pins a device"


def test_device_examples_raise_without_cuda_or_the_pin(monkeypatch):
    """With neither CUDA nor the host pin, an example that touches the
    device raises rather than run on the host."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    monkeypatch.setattr(logging_config, "_PINNED", None)
    monkeypatch.setattr(port_backends, "_BACKENDS", {})
    from tnc_tpu_torch.examples import distributed_contraction, local_contraction

    for module in (local_contraction, distributed_contraction):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            module.main()


def test_do_run_distributed_places_a_slot_per_partition(tmp_path, host, monkeypatch, caplog):
    """``do_run(..., distributed=True)`` on a 2-partition scenario: one
    device slot a partition (the host under the pin), no ERROR record, the
    run's fields those of the in-process run, and the same statevector."""
    from tnc_tpu_torch.benchmark.cache import ArtifactCache
    from tnc_tpu_torch.benchmark.driver import Scenario, do_run, do_sweep
    from tnc_tpu_torch.benchmark.protocol import Protocol
    from tnc_tpu_torch.benchmark.results import ResultWriter
    from tnc_tpu_torch.io.qasm import import_qasm
    from tnc_tpu_torch.tensornetwork.contraction import contract_tensor_network

    text = "\n".join(["OPENQASM 2.0;", 'include "qelib1.inc";', "qreg q[8];", "h q;"]
                     + [f"cx q[{i}], q[{i + 1}];" for i in range(7)]
                     + [f"rz({0.1 * (i + 1)!r}) q[{i}];" for i in range(8)]
                     + [f"cz q[{i}], q[{(i + 3) % 8}];" for i in range(8)]) + "\n"
    sc = Scenario("c8", text, 2, 0, "greedy")
    cache = ArtifactCache(tmp_path / "cache")
    tn, _ = import_qasm(text).into_statevector_network()
    do_sweep(sc, tn, cache, ResultWriter(tmp_path / "s.jsonl"), Protocol(tmp_path / "s.p"))
    seen = []
    real = port_parallel.distributed_partitioned_contraction

    def spy(tn, path, **kw):
        out = real(tn, path, **kw)
        seen.append((kw.get("devices"), out))
        return out

    monkeypatch.setattr(port_parallel, "distributed_partitioned_contraction", spy)
    runs = {}
    with caplog.at_level(logging.INFO):
        for distributed in (False, True):
            writer = ResultWriter(tmp_path / f"r{distributed}.jsonl")
            runs[distributed] = do_run(sc, cache, writer, Protocol(tmp_path / f"p{distributed}"),
                                       distributed=distributed)
    assert not [r for r in caplog.records if r.levelno >= logging.ERROR]
    fields = ("id", "method", "circuit", "partitions", "seed", "backend", "resumed")
    assert {f: getattr(runs[True], f) for f in fields} == {
        f: getattr(runs[False], f) for f in fields}
    assert runs[True].time_to_solution > 0
    (devices, dist), = seen
    assert [d.type for d in devices] == ["cpu", "cpu"]
    ptn, path = cache.load(sc.key())
    want = contract_tensor_network(ptn, path, "numpy")
    perm = [dist.legs.index(leg) for leg in want.legs]
    got = np.transpose(np.asarray(dist.data.into_data()), perm)
    assert np.max(np.abs(got - np.asarray(want.data.into_data()))) <= 1e-5
