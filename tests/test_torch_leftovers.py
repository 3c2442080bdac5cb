"""The leftovers of the copied modules against the reference on the CPU:
``builders.tensorgeneration`` bitwise for the same seeds, the observable
and sweep builders of ``builders.random_circuit`` leaf by leaf,
``ops.structure`` reports equal, ``gates.gate_arity`` on every gate, the
``Cotengrust`` alias, ``tensordata.DataTensor``, the north star's
``oracle_key`` and ``plan_fingerprint``, the process-parallel numpy oracle
(``ops.sliced.sliced_partials_numpy``, ``execute_sliced_numpy_parallel``)
equal to the reference's, and ``utils.logging_config`` (``TNC_TPU_LOG`` as
the reference's tests expect it, and the platform pin:
``TNC_TPU_PLATFORM=cpu`` makes ``device=None`` the host)."""

import hashlib
import importlib
import logging
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

import tnc_tpu.builders.tensorgeneration as ref_tg
import tnc_tpu.gates as ref_gates
import tnc_tpu.ops.structure as ref_structure
from tnc_tpu.benchmark.northstar import oracle_key as ref_oracle_key
from tnc_tpu.builders.connectivity import ConnectivityLayout as RefLayout
from tnc_tpu.contractionpath.paths import Greedy as RefGreedy
from tnc_tpu.contractionpath.paths import OptMethod as RefOptMethod
from tnc_tpu.contractionpath.slicing import find_slicing as ref_find_slicing
from tnc_tpu.ops.sliced import build_sliced_program as ref_build_sliced
from tnc_tpu.ops.sliced import execute_sliced_numpy_parallel as ref_parallel
from tnc_tpu.ops.sliced import sliced_partials_numpy as ref_partials
from tnc_tpu_torch import gates
from tnc_tpu_torch.benchmark import northstar
from tnc_tpu_torch.builders import tensorgeneration as tg
from tnc_tpu_torch.builders.connectivity import ConnectivityLayout
from tnc_tpu_torch.contractionpath.paths import Greedy, OptMethod
from tnc_tpu_torch.contractionpath.paths import greedy as greedy_mod
from tnc_tpu_torch.contractionpath.slicing import find_slicing
from tnc_tpu_torch.ops import backends, sliced, structure
from tnc_tpu_torch.ops.program import flat_leaf_tensors
from tnc_tpu_torch.ops.sliced import build_sliced_program
from tnc_tpu_torch.tensornetwork import tensordata
from tnc_tpu_torch.utils import logging_config

# the packages export a function of the module's name from builders/
rc = importlib.import_module("tnc_tpu_torch.builders.random_circuit")
ref_rc = importlib.import_module("tnc_tpu.builders.random_circuit")

PARTIALS_TOL = 1e-12  # complex128 slices of both packages' numpy oracles


def leaves(tn) -> list:
    """A network's leaves as plain tuples (legs, dims, kind, payload or the
    matrix's bytes)."""
    out = []
    for t in tn.tensors:
        kind = t.data.kind.name
        payload = (t.data.payload if kind == "GATE" else
                   t.data.into_data().tobytes() if kind == "MATRIX" else None)
        out.append((tuple(t.legs), tuple(t.bond_dims), kind, payload))
    return out


# -- builders ------------------------------------------------------------------


@pytest.mark.parametrize("dims,sparsity,seed", [
    ([2], 1.0, 0), ([2, 2], 0.5, 1), ([3, 4, 2], 0.25, 2), ([2, 2, 2, 2], None, 3),
    ([5], 0.0, 4), ([4, 4], 0.9, 5)])
def test_tensorgeneration_bitwise(dims, sparsity, seed):
    port = tg.random_sparse_tensor_data_with_rng(dims, sparsity, np.random.default_rng(seed))
    ref = ref_tg.random_sparse_tensor_data_with_rng(dims, sparsity, np.random.default_rng(seed))
    assert port.into_data().tobytes() == ref.into_data().tobytes()
    assert port.into_data().dtype == np.complex128


def test_tensorgeneration_rejects_bad_sparsity():
    with pytest.raises(ValueError, match="sparsity must be in"):
        tg.random_sparse_tensor_data([2], 1.5)
    assert tg.random_sparse_tensor_data([2, 3]).into_data().shape == (2, 3)


@pytest.mark.parametrize("qubits,rounds,p_obs,seed,layout", [
    (6, 4, 0.5, 0, "LINE"), (10, 6, 0.3, 1, "SYCAMORE"), (16, 8, 0.5, 42, "SYCAMORE"),
    (8, 5, 1.0, 7, "LINE")])
def test_random_circuit_with_observable(qubits, rounds, p_obs, seed, layout):
    port = rc.random_circuit_with_observable(qubits, rounds, 0.4, 0.4, p_obs,
                                             np.random.default_rng(seed),
                                             getattr(ConnectivityLayout, layout))
    ref = ref_rc.random_circuit_with_observable(qubits, rounds, 0.4, 0.4, p_obs,
                                                np.random.default_rng(seed),
                                                getattr(RefLayout, layout))
    assert leaves(port) == leaves(ref)
    assert rc._OBSERVABLES == ref_rc._OBSERVABLES


@pytest.mark.parametrize("locations", [[0], [2, 5], [], [0, 1, 2, 3, 4, 5, 6, 7]])
def test_random_circuit_with_set_observable(locations):
    port = rc.random_circuit_with_set_observable(8, 6, 0.5, 0.5, locations,
                                                 np.random.default_rng(3),
                                                 ConnectivityLayout.LINE)
    ref = ref_rc.random_circuit_with_set_observable(8, 6, 0.5, 0.5, locations,
                                                    np.random.default_rng(3), RefLayout.LINE)
    assert leaves(port) == leaves(ref)
    if not locations:  # no observable: every gate lies outside the light cone
        assert leaves(port) == []


def test_observable_network_value():
    """The ⟨O⟩ network chip_smoke.py phase 19 contracts, on both packages'
    numpy oracles (complex128, within 1e-12)."""
    port = rc.random_circuit_with_observable(16, 8, 0.4, 0.4, 0.5, np.random.default_rng(42),
                                             ConnectivityLayout.SYCAMORE)
    ref = ref_rc.random_circuit_with_observable(16, 8, 0.4, 0.4, 0.5,
                                                np.random.default_rng(42), RefLayout.SYCAMORE)
    from tnc_tpu.tensornetwork.contraction import contract_tensor_network as ref_contract
    from tnc_tpu_torch.tensornetwork.contraction import contract_tensor_network

    got = complex(contract_tensor_network(
        port, Greedy(OptMethod.GREEDY).find_path(port).replace_path(), "numpy").data.into_data())
    want = complex(ref_contract(
        ref, RefGreedy(RefOptMethod.GREEDY).find_path(ref).replace_path(),
        "numpy").data.into_data())
    assert abs(got - want) <= 1e-12 * max(abs(want), 1.0)


@pytest.mark.parametrize("qubits,depth,prefix,settings,seed", [
    (4, 3, 2, 2, 0), (6, 5, 0, 3, 1), (5, 4, 4, 1, 2), (3, 2, 9, 0, 3)])
def test_brickwork_sweep(qubits, depth, prefix, settings, seed):
    port = rc.brickwork_sweep(qubits, depth, prefix, settings, np.random.default_rng(seed))
    ref = ref_rc.brickwork_sweep(qubits, depth, prefix, settings, np.random.default_rng(seed))
    assert len(port) == len(ref) == max(settings, 1)
    for p, r in zip(port, ref):
        assert leaves(p.tensor_network) == leaves(r.tensor_network)


# -- structure, gates, aliases --------------------------------------------------


def test_classify_array_on_every_gate():
    for name in gates.gate_names():
        for angles in ((), (0.3,), (0.3, 0.2), (0.1, 0.2, 0.3)):
            try:
                data = gates.load_gate(name, angles)
            except (ValueError, TypeError):
                continue
            assert structure.classify_array(data) == ref_structure.classify_array(data), name
    for arr in (np.eye(4), 2j * np.eye(4), np.zeros((2, 2)), np.arange(6.0), np.ones((2, 2))):
        assert structure.classify_array(arr) == ref_structure.classify_array(arr)
    assert structure.CLASSES == ref_structure.CLASSES


@pytest.mark.parametrize("seed", [3, 4])
def test_program_structure_report(seed):
    port = rc.random_circuit(10, 6, 0.5, 0.5, np.random.default_rng(seed),
                             ConnectivityLayout.LINE)
    ref = ref_rc.random_circuit(10, 6, 0.5, 0.5, np.random.default_rng(seed), RefLayout.LINE)
    got = structure.program_structure_report(
        port, Greedy(OptMethod.GREEDY).find_path(port).replace_path().toplevel)
    want = ref_structure.program_structure_report(
        ref, RefGreedy(RefOptMethod.GREEDY).find_path(ref).replace_path().toplevel)
    assert got.leaf_classes == want.leaf_classes
    assert got.step_flops == want.step_flops
    assert got.total_flops == want.total_flops
    assert got.exploitable_fraction == want.exploitable_fraction


def test_structure_report_rejects_nested():
    from tnc_tpu_torch.tensornetwork.tensor import CompositeTensor, LeafTensor

    tn = CompositeTensor([CompositeTensor([LeafTensor([0], [2]), LeafTensor([0, 1], [2, 2])]),
                          LeafTensor([1], [2])])
    with pytest.raises(ValueError, match="flat network"):
        structure.program_structure_report(tn, [(0, 1)])


def test_gate_arity_on_every_gate():
    assert gates.gate_names() == ref_gates.gate_names()
    for name in gates.gate_names():
        assert gates.gate_arity(name) == ref_gates.gate_arity(name)
    assert gates.gate_arity("nonsense") is None


def test_cotengrust_and_data_tensor():
    assert greedy_mod.Cotengrust is Greedy
    assert tensordata.DataTensor is np.ndarray
    assert [k.name for k in tensordata.DataKind] == ["NONE", "GATE", "FILE", "MATRIX"]
    f = tensordata.TensorData.file("x.h5", 3)
    assert f.adjoint() == tensordata.TensorData.file("x.h5", 3, True)
    assert repr(f) == "TensorData.file(('x.h5', 3, False))"


# -- the north star's keys ---------------------------------------------------------


def test_oracle_key():
    key = northstar.northstar_plan_key(53, 14, 42, 128, 29.0)
    assert northstar.oracle_key(key) == ref_oracle_key(key)
    assert northstar.oracle_key(key).startswith("northstar-oracle-v2-json_")
    for other in ("northstar-plan-v2_abc_42_1_hyper", "plain"):
        assert northstar.oracle_key(other) == ref_oracle_key(other)


def sliced_programs(qubits=12, depth=4, seed=5, target=None):
    """The same sliced program in both packages: a Sycamore amplitude, the
    Greedy path, sliced to half its peak (8 slices; a target far under the
    peak gives millions)."""
    from tnc_tpu.builders.sycamore_circuit import sycamore_circuit as ref_syc
    from tnc_tpu_torch.builders.sycamore_circuit import sycamore_circuit

    tn, _ = sycamore_circuit(qubits, depth, np.random.default_rng(seed)).into_amplitude_network(
        "0" * qubits)
    rtn, _ = ref_syc(qubits, depth, np.random.default_rng(seed)).into_amplitude_network(
        "0" * qubits)
    res = Greedy(OptMethod.GREEDY).find_path(tn)
    rres = RefGreedy(RefOptMethod.GREEDY).find_path(rtn)
    target = res.size / 2 if target is None else target
    slicing = find_slicing(tn.tensors, res.replace_path().toplevel, target)
    rslicing = ref_find_slicing(rtn.tensors, rres.replace_path().toplevel, target)
    sp = build_sliced_program(tn, res.replace_path(), slicing)
    rsp = ref_build_sliced(rtn, rres.replace_path(), rslicing)
    arrays = [leaf.data.into_data() for leaf in flat_leaf_tensors(tn)]
    return sp, rsp, arrays


def test_plan_fingerprint():
    """The reference's formula on the port's signature: stable for one plan
    (another seed gives the same structure, so the same plan), another for
    another plan (the digest pickles the port's own classes, so
    its value names the plan within the port: a recorded divergence)."""
    sp, _, _ = sliced_programs()
    again, _, _ = sliced_programs()
    same, _, _ = sliced_programs(seed=6)
    other, _, _ = sliced_programs(depth=5)
    fp = northstar.plan_fingerprint(sp)
    assert fp == northstar.plan_fingerprint(again) == northstar.plan_fingerprint(same)
    assert len(fp) == 16
    assert fp != northstar.plan_fingerprint(other)
    assert fp == hashlib.sha256(pickle.dumps((sp.signature(),))).hexdigest()[:16]


# -- the process-parallel numpy oracle -------------------------------------------


@pytest.mark.parametrize("workers,hoist", [(1, False), (1, True), (2, False), (2, True)])
def test_sliced_partials_numpy(workers, hoist):
    sp, rsp, arrays = sliced_programs()
    assert sp.slicing.num_slices == rsp.slicing.num_slices == 8
    ids = [0, 3, 5, 7]
    got = sliced.sliced_partials_numpy(sp, arrays, slice_ids=ids, workers=workers, hoist=hoist)
    want = ref_partials(rsp, arrays, slice_ids=ids, workers=1, hoist=hoist)
    assert got.shape == want.shape == (len(ids),) + tuple(sp.program.result_shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=PARTIALS_TOL * float(np.max(np.abs(want))))


def test_execute_sliced_numpy_parallel():
    """The sum over every slice equals the reference's and the serial oracle
    (``execute_sliced_numpy``); ``max_slices`` keeps the first slices."""
    sp, rsp, arrays = sliced_programs()
    got = sliced.execute_sliced_numpy_parallel(sp, arrays, workers=2)
    want = ref_parallel(rsp, arrays, workers=1)
    serial = sliced.execute_sliced_numpy(sp, arrays)
    scale = float(np.max(np.abs(want)))
    np.testing.assert_allclose(got, want, rtol=0, atol=PARTIALS_TOL * scale)
    np.testing.assert_allclose(got, serial, rtol=0, atol=PARTIALS_TOL * scale)
    part = sliced.execute_sliced_numpy_parallel(sp, arrays, max_slices=2, workers=1)
    np.testing.assert_allclose(part, ref_parallel(rsp, arrays, max_slices=2, workers=1),
                               rtol=0, atol=PARTIALS_TOL * scale)


# -- logging and the platform pin ------------------------------------------------


@pytest.fixture
def pin():
    """Restore the platform pin after a test that sets it."""
    saved = logging_config._PINNED
    yield
    logging_config._PINNED = saved


def test_configure_from_env_attaches_once(monkeypatch):
    root = logging.getLogger("tnc_tpu_torch")
    before = [h for h in root.handlers if getattr(h, "_tnc_tpu_env", False)]
    level = root.level
    for h in before:
        root.removeHandler(h)
    try:
        monkeypatch.setenv("TNC_TPU_LOG", "debug")
        logging_config.configure_from_env()
        logging_config.configure_from_env()  # idempotent: no duplicates
        envh = [h for h in root.handlers if getattr(h, "_tnc_tpu_env", False)]
        assert len(envh) == 1
        assert root.level == logging.DEBUG
    finally:
        for h in root.handlers[:]:
            if getattr(h, "_tnc_tpu_env", False):
                root.removeHandler(h)
        for h in before:
            root.addHandler(h)
        root.setLevel(level)


def test_configure_from_env_rejects_bad_level(monkeypatch):
    root = logging.getLogger("tnc_tpu_torch")
    before = [h for h in root.handlers if getattr(h, "_tnc_tpu_env", False)]
    for h in before:
        root.removeHandler(h)
    try:
        monkeypatch.setenv("TNC_TPU_LOG", "not-a-level")
        logging_config.configure_from_env()
        assert not [h for h in root.handlers if getattr(h, "_tnc_tpu_env", False)]
    finally:
        for h in before:
            root.addHandler(h)


def test_pin_platform_noop_without_env(monkeypatch, pin):
    monkeypatch.delenv("TNC_TPU_PLATFORM", raising=False)
    logging_config._PINNED = None
    logging_config.pin_platform_from_env()
    assert logging_config.pinned_device() == "cuda"


def test_pin_platform_warns_on_an_unknown_platform(monkeypatch, caplog, pin):
    """An unknown value logs the reference's warning and changes nothing."""
    logging_config._PINNED = None
    monkeypatch.setenv("TNC_TPU_PLATFORM", "tpu")
    with caplog.at_level(logging.WARNING, logger="tnc_tpu_torch"):
        logging_config.pin_platform_from_env()
    assert any("could not pin platform 'tpu'" in r.getMessage() for r in caplog.records)
    assert logging_config.pinned_device() == "cuda"


@pytest.mark.parametrize("value,device", [("cpu", "cpu"), ("CPU", "cpu"), ("cuda", "cuda"),
                                          ("gpu", "cuda")])
def test_pin_platform(monkeypatch, pin, value, device):
    """``cpu`` makes ``device=None`` the host for ``resolve_device``,
    ``TorchBackend()`` and ``get_backend("torch")``; ``cuda`` or ``gpu`` the
    card, which raises here: the pin is the caller asking, not a
    fallback."""
    logging_config._PINNED = None
    monkeypatch.setenv("TNC_TPU_PLATFORM", value)
    logging_config.pin_platform_from_env()
    assert logging_config.pinned_device() == device
    if device == "cpu":
        assert backends.resolve_device(None).type == "cpu"
        backend = backends.TorchBackend()
        assert backend.device.type == "cpu" and backend.split_complex is False
        monkeypatch.setattr(backends, "_BACKENDS", {})
        assert backends.get_backend("torch").device.type == "cpu"
        assert backends.resolve_device("cpu").type == "cpu"
    else:
        import torch

        if torch.cuda.is_available():
            pytest.skip("this machine has a card")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            backends.TorchBackend()


def test_unpinned_backend_still_raises_without_cuda(pin):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    logging_config._PINNED = None
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        backends.TorchBackend()


def test_package_import_pins_from_the_environment():
    """``import tnc_tpu_torch`` reads ``TNC_TPU_PLATFORM`` and imports no
    torch for it."""
    code = ("import sys, tnc_tpu_torch; from tnc_tpu_torch.utils import logging_config as c; "
            "print(c.pinned_device(), 'torch' in sys.modules)")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for value, want in (("cpu", "cpu False"), ("", "cuda False"), ("tpu", "cuda False")):
        env = dict(os.environ, TNC_TPU_PLATFORM=value)
        out = subprocess.run([sys.executable, "-c", code], env=env, cwd=repo,
                             capture_output=True, text=True, check=True)
        assert out.stdout.strip() == want


def test_new_host_modules_import_no_torch():
    """The host modules of this slice load without torch (the SA and
    genetic spawn workers import the planner)."""
    code = ("import sys; import tnc_tpu_torch.benchmark, tnc_tpu_torch.benchmark.cli, "
            "tnc_tpu_torch.io, tnc_tpu_torch.io.qasm, tnc_tpu_torch.builders.tensorgeneration, "
            "tnc_tpu_torch.builders.random_circuit, tnc_tpu_torch.ops.structure, "
            "tnc_tpu_torch.utils.logging_config; print('torch' in sys.modules)")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "False"


@pytest.mark.parametrize("module", [tg, rc, structure, logging_config, gates, northstar,
                                    tensordata, sliced])
def test_doctests(module):
    import doctest

    assert doctest.testmod(module).failed == 0
