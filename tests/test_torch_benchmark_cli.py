"""The port's research benchmark (``tnc_tpu_torch.benchmark``: results,
protocol, artifact cache, JSON logging, the ten sweep methods, the Sweep
and Run phases and the CLI) against the reference's (``tnc_tpu.benchmark``)
on the CPU. The clock-free methods (``greedy``, ``greedy-balance``,
``tree-temper``) give the reference's records and artifacts bit for bit at
the same seed; the time-bounded ones a valid plan. ``python -m
tnc_tpu_torch.benchmark sweep`` then ``run`` in subprocesses under
``TNC_TPU_PLATFORM=cpu`` on a 10-qubit circuit, whose loaded artifact
contracts to the reference's statevector within 1e-5 (complex64 on the
host against complex128)."""

import argparse
import dataclasses
import json
import logging
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from tnc_tpu.benchmark import METHODS as REF_METHODS
from tnc_tpu.benchmark import ArtifactCache as RefCache
from tnc_tpu.benchmark import Protocol as RefProtocol
from tnc_tpu.benchmark import ResultWriter as RefWriter
from tnc_tpu.benchmark.cache import cache_key as ref_cache_key
from tnc_tpu.benchmark.cli import enumerate_scenarios as ref_enumerate
from tnc_tpu.benchmark.driver import Scenario as RefScenario
from tnc_tpu.benchmark.driver import do_sweep as ref_do_sweep
from tnc_tpu.benchmark.results import OptimizationResult as RefOptimizationResult
from tnc_tpu.benchmark.results import RunResult as RefRunResult
from tnc_tpu.contractionpath.contraction_path import ContractionPath as RefPath
from tnc_tpu.contractionpath.paths import Greedy as RefGreedy
from tnc_tpu.contractionpath.paths import OptMethod as RefOptMethod
from tnc_tpu.io.qasm import import_qasm as ref_import
from tnc_tpu.tensornetwork.contraction import contract_tensor_network as ref_contract
from tnc_tpu_torch.benchmark import (
    METHODS,
    ArtifactCache,
    OptimizationResult,
    Protocol,
    ResultWriter,
    RunResult,
)
from tnc_tpu_torch.benchmark import cache as cache_mod
from tnc_tpu_torch.benchmark import cli, driver, logging_util, methods, protocol, results
from tnc_tpu_torch.benchmark.cache import cache_key
from tnc_tpu_torch.benchmark.driver import Scenario, do_run, do_sweep
from tnc_tpu_torch.contractionpath.contraction_path import ContractionPath
from tnc_tpu_torch.contractionpath.paths import Greedy, OptMethod
from tnc_tpu_torch.io.qasm import import_qasm
from tnc_tpu_torch.ops.backends import TorchBackend
from tnc_tpu_torch.ops.program import build_program
from tnc_tpu_torch.tensornetwork.contraction import contract_tensor_network

from _torch_partition_cases import path_obj, tensor_obj

REPO = pathlib.Path(__file__).resolve().parents[1]
SV_TOL = 1e-5  # the port's complex64 host contraction against complex128

CLOCK_FREE = ("greedy", "greedy-balance", "tree-temper")
TIME_BOUNDED = ("sa-naive", "sa-naive-intermediate", "sa-leaf", "sa-intermediate",
                "genetic", "tree-anneal", "hyper")


def circuit_text(qubits: int, seed: int) -> str:
    """A seeded brickwork-like QASM circuit: an H layer by broadcast, rounds
    of ``u3`` and ``cz`` / ``fsim`` on a line, a user gate."""
    rng = np.random.default_rng(seed)
    lines = ["OPENQASM 2.0;", 'include "qelib1.inc";',
             "gate zx(a) q { rz(a) q; sx q; rz(-a/2) q; }", f"qreg q[{qubits}];", "h q;"]
    for r in range(4):
        for i in range(qubits):
            a = float(rng.uniform(0, 3))
            lines.append(f"u3({a!r}, {a / 2!r}, -{a!r}) q[{i}];" if rng.random() < 0.5
                         else f"zx({a!r}) q[{i}];")
        for i in range(r % 2, qubits - 1, 2):
            lines.append(f"{'cz' if rng.random() < 0.5 else 'fsim(0.3, 0.2)'} q[{i}], q[{i + 1}];")
        if r % 2:
            lines.append(f"cx q[0], q[{qubits - 1}];")
    return "\n".join(lines) + "\n"


def networks(text: str):
    port, _ = import_qasm(text).into_statevector_network()
    ref, _ = ref_import(text).into_statevector_network()
    return port, ref


@pytest.fixture
def serial_workers(monkeypatch):
    """The SA and genetic searches without a spawn pool (the same chains
    run serially)."""
    monkeypatch.setenv("TNC_TPU_SA_WORKERS", "1")


# -- records, protocol, cache -------------------------------------------------


def test_records_match_the_references():
    ref_fields = {f.name: f.default for f in dataclasses.fields(RefRunResult)}
    port_fields = {f.name: f.default for f in dataclasses.fields(RunResult)}
    assert list(port_fields) == list(ref_fields)
    assert port_fields["backend"] == "torch"  # the reference's default is "jax"
    assert [f.name for f in dataclasses.fields(OptimizationResult)] == [
        f.name for f in dataclasses.fields(RefOptimizationResult)]


def test_result_writer_lines_read_by_the_reference(tmp_path):
    path = tmp_path / "results.jsonl"
    ResultWriter(path).write(RunResult("id1", "sa", "ghz", 4, 7, 1.5))
    RefWriter(path).write(RefRunResult("id2", "sa", "ghz", 4, 7, 2.5, backend="torch"))
    assert ResultWriter(path).read_all() == RefWriter(path).read_all()
    assert [r["time_to_solution"] for r in ResultWriter(path).read_all()] == [1.5, 2.5]


@pytest.mark.parametrize("reader", ["port", "reference"])
def test_protocol_crash_resume(tmp_path, reader):
    """A journal written by one package resumes in either: a crashed cell is
    an Error and skipped; with a checkpoint dir, a crashed cell that left a
    checkpoint is requeued, at most ``max_resumes`` times."""
    cls = {"port": Protocol, "reference": RefProtocol}[reader]
    p = tmp_path / "protocol.jsonl"
    proto = Protocol(p)
    proto.trying("a")
    proto.done("a")
    proto.trying("b")
    back = cls(p)
    assert not back.should_run("a") and not back.should_run("b")
    assert back.completed == {"a"} and back.failed == {"b"}
    assert back.should_run("c")

    ckpt = tmp_path / "ckpt"
    p2 = tmp_path / "p2.jsonl"
    first = Protocol(p2, checkpoint_dir=ckpt)
    first.trying("cell")
    cell = protocol.cell_checkpoint_dir(ckpt, "cell")
    cell.mkdir(parents=True)
    (cell / "ckpt_0.npz").write_bytes(b"x")
    for _ in range(3):
        again = cls(p2, checkpoint_dir=ckpt, max_resumes=3)
        assert again.should_run("cell") and again.resumable == {"cell"}
        again.trying("cell")
    spent = cls(p2, checkpoint_dir=ckpt, max_resumes=3)
    assert not spent.should_run("cell") and spent.failed == {"cell"}


def test_cell_checkpoint_dir_is_the_references():
    from tnc_tpu.benchmark.protocol import cell_checkpoint_dir as ref_cell

    assert protocol.cell_checkpoint_dir("/x", "run-torch/a_b") == ref_cell("/x", "run-torch/a_b")


@pytest.mark.parametrize("args", [("greedy", "OPENQASM 2.0;", 7, 4, "sa"),
                                  ("northstar-plan-v2", circuit_text(5, 1), 0, 1, "hyper")])
def test_cache_key_is_the_references(args):
    assert cache_key(*args) == ref_cache_key(*args)


def test_artifact_cache_round_trip(tmp_path):
    """A partitioned network and nested path survive the cache: the loaded
    pair compiles to the same program (the GATE payloads and the nested
    dict pickled)."""
    text = circuit_text(6, 2)
    tn, _ = networks(text)
    ptn, ppath = METHODS["greedy"].run(methods.MethodContext(tn, 2, 0, 5.0))
    assert ppath.nested
    cache = ArtifactCache(tmp_path / "cache")
    assert not cache.has("k") and cache.load("k") is None
    cache.store("k", ptn, ppath)
    tn2, path2 = cache.load("k")
    assert build_program(tn2, path2).signature() == build_program(ptn, ppath).signature()
    assert tensor_obj(tn2) == tensor_obj(ptn) and path_obj(path2) == path_obj(ppath)
    assert [t.data for t in tn2.tensors[0].tensors] == [t.data for t in ptn.tensors[0].tensors]
    assert any(t.data.kind.name == "GATE" for t in tn2.tensors[0].tensors)
    cache.store_obj("obj", {"plan": [1, 2]})
    assert cache.load_obj("obj") == {"plan": [1, 2]}
    (tmp_path / "cache" / "bad").write_bytes(b"not zlib")
    assert cache.load_obj("bad") is None


def test_cache_artifacts_do_not_cross_packages(tmp_path):
    """The artifact pickles each package's own classes: the port's names
    ``tnc_tpu_torch`` modules and the reference's ``tnc_tpu`` ones (a
    recorded divergence: neither loads the other's)."""
    import pickle
    import zlib

    text = circuit_text(4, 3)
    port_tn, ref_tn = networks(text)
    ArtifactCache(tmp_path).store("p", port_tn, ContractionPath.simple([(0, 1)]))
    RefCache(tmp_path).store("r", ref_tn, RefPath.simple([(0, 1)]))
    port_blob = zlib.decompress((tmp_path / "p").read_bytes())
    ref_blob = zlib.decompress((tmp_path / "r").read_bytes())
    assert b"tnc_tpu_torch" in port_blob and b"tnc_tpu_torch" not in ref_blob
    assert type(pickle.loads(port_blob)[0]).__module__.startswith("tnc_tpu_torch")


# -- methods and the Sweep / Run phases ---------------------------------------


def test_the_ten_methods():
    assert sorted(METHODS) == sorted(REF_METHODS)
    assert len(METHODS) == 10
    assert set(CLOCK_FREE + TIME_BOUNDED) == set(METHODS)


def sweep_both(tmp_path, method: str, partitions: int, seed: int):
    text = circuit_text(8, 5)
    port_tn, ref_tn = networks(text)
    port_sc = Scenario("c8", text, partitions, seed, method)
    ref_sc = RefScenario("c8", text, partitions, seed, method)
    assert port_sc.key() == ref_sc.key() and port_sc.run_id == ref_sc.run_id
    port_cache, ref_cache = ArtifactCache(tmp_path / "p"), RefCache(tmp_path / "r")
    port = do_sweep(port_sc, port_tn, port_cache, ResultWriter(tmp_path / "p.jsonl"),
                    Protocol(tmp_path / "pp.jsonl"), time_budget=5.0)
    ref = ref_do_sweep(ref_sc, ref_tn, ref_cache, RefWriter(tmp_path / "r.jsonl"),
                       RefProtocol(tmp_path / "rp.jsonl"), time_budget=5.0)
    return port, ref, port_cache.load(port_sc.key()), ref_cache.load(ref_sc.key()), port_tn


@pytest.mark.parametrize("method", CLOCK_FREE)
@pytest.mark.parametrize("partitions,seed", [(2, 0), (3, 4)])
def test_clock_free_sweeps_equal_the_references(tmp_path, method, partitions, seed):
    """The same record (all but the optimization seconds) and the same
    artifact (network and nested path)."""
    port, ref, (ptn, ppath), (rtn, rpath), _ = sweep_both(tmp_path, method, partitions, seed)
    port_rec = {k: v for k, v in port.__dict__.items() if k != "optimization_time"}
    ref_rec = {k: v for k, v in ref.__dict__.items() if k != "optimization_time"}
    assert port_rec == ref_rec
    assert tensor_obj(ptn) == tensor_obj(rtn)
    assert path_obj(ppath) == path_obj(rpath)


@pytest.mark.parametrize("method", TIME_BOUNDED)
def test_time_bounded_methods_give_valid_plans(tmp_path, serial_workers, method):
    """A plan over every leaf that contracts to the Greedy plan's value
    (complex128, within 1e-10)."""
    text = circuit_text(6, 7)
    tn, _ = networks(text)
    ctx = methods.MethodContext(tn, 2, 1, time_budget=0.5)
    ptn, ppath = METHODS[method].run(ctx)
    program = build_program(ptn, ppath)
    assert program.num_inputs == len(tn.tensors)
    got = contract_tensor_network(ptn, ppath, "numpy")
    want = contract_tensor_network(tn, Greedy(OptMethod.GREEDY).find_path(tn).replace_path(),
                                   "numpy")
    order = [list(got.legs).index(leg) for leg in want.legs]
    np.testing.assert_allclose(np.transpose(got.data.into_data(), order),
                               want.data.into_data(), rtol=0, atol=1e-10)


def test_do_run_numpy(tmp_path):
    """The Run phase on the numpy oracle: a RunResult, Done, and a second
    call skipped; a missing artifact raises."""
    text = circuit_text(6, 8)
    tn, _ = networks(text)
    sc = Scenario("c6", text, 2, 0, "greedy")
    cache, writer = ArtifactCache(tmp_path / "c"), ResultWriter(tmp_path / "r.jsonl")
    proto = Protocol(tmp_path / "p.jsonl")
    with pytest.raises(FileNotFoundError, match="run the sweep first"):
        do_run(sc, cache, writer, proto, backend="numpy")
    do_sweep(sc, tn, cache, writer, proto)
    rec = do_run(sc, cache, writer, proto, backend="numpy", repeats=2)
    assert rec.id == "run-numpy/greedy_c6_p2_s0" and rec.backend == "numpy"
    assert rec.time_to_solution > 0 and not rec.resumed
    assert do_run(sc, cache, writer, Protocol(tmp_path / "p.jsonl"), backend="numpy") is None
    kinds = [r["kind"] for r in writer.read_all()]
    assert kinds == ["OptimizationResult", "RunResult"]


def test_do_run_under_a_checkpoint_dir(tmp_path, monkeypatch):
    """``checkpoint_dir`` sets a per-cell ``TNC_TPU_CKPT`` while the cell
    runs and restores the variable after."""
    seen = []
    text = circuit_text(4, 9)
    tn, _ = networks(text)
    sc = Scenario("c4", text, 2, 0, "greedy")
    cache, writer = ArtifactCache(tmp_path / "c"), ResultWriter(tmp_path / "r.jsonl")
    proto = Protocol(tmp_path / "p.jsonl")
    do_sweep(sc, tn, cache, writer, proto)
    real = driver.contract_tensor_network

    def spy(*a, **k):
        seen.append(os.environ.get("TNC_TPU_CKPT"))
        return real(*a, **k)

    monkeypatch.setattr(driver, "contract_tensor_network", spy)
    monkeypatch.delenv("TNC_TPU_CKPT", raising=False)
    do_run(sc, cache, writer, proto, backend="numpy", checkpoint_dir=tmp_path / "ck")
    assert seen == [str(tmp_path / "ck" / "run-numpy_greedy_c4_p2_s0")]
    assert "TNC_TPU_CKPT" not in os.environ


def test_enumerate_scenarios_is_the_references(tmp_path):
    for name in ("b", "a"):
        (tmp_path / f"{name}.qasm").write_text(circuit_text(3, 0))
    for include, exclude in ((None, None), ((0, 8), (1, 7)), ((2, 5), None)):
        args = argparse.Namespace(circuits_dir=tmp_path, partitions=[2, 4], seeds=[0],
                                  methods=["greedy", "tree-temper"], include=include,
                                  exclude=exclude)
        port = [(s.circuit_name, s.partitions, s.method) for s in cli.enumerate_scenarios(args)]
        ref = [(s.circuit_name, s.partitions, s.method) for s in ref_enumerate(args)]
        assert port == ref
    assert port == [("a", 4, "greedy"), ("a", 4, "tree-temper"), ("b", 2, "greedy")]


def test_parser_defaults():
    args = cli.build_parser().parse_args(["run", "--circuits-dir", "x"])
    assert args.backend == "torch" and args.methods == ["greedy"] and args.partitions == [4]
    with pytest.raises(SystemExit):
        cli.main(["definitely-not-a-command"])


def test_module_entry_is_cli_main():
    import runpy
    from unittest import mock

    with mock.patch.object(sys, "argv", ["tnc_tpu_torch.benchmark", "--help"]):
        with pytest.raises(SystemExit) as exc:
            runpy.run_module("tnc_tpu_torch.benchmark", run_name="__main__")
    assert exc.value.code in (0, None)


def test_cli_logs_a_failed_scenario_and_goes_on(tmp_path, caplog):
    """A scenario that fails (no artifact: run before sweep) is logged as an
    error and the CLI returns 0, as the reference's does."""
    (tmp_path / "c").mkdir()
    (tmp_path / "c" / "x.qasm").write_text(circuit_text(3, 1))
    argv = ["run", "--circuits-dir", str(tmp_path / "c"), "--cache-dir", str(tmp_path / "k"),
            "--out", str(tmp_path / "r.jsonl"), "--protocol", str(tmp_path / "p.jsonl"),
            "--backend", "numpy"]
    root = logging.getLogger("tnc_tpu_torch")
    before, level = list(root.handlers), root.level
    try:
        with caplog.at_level(logging.ERROR, logger="tnc_tpu_torch.benchmark"):
            assert cli.main(argv) == 0
    finally:
        for h in root.handlers[:]:
            if h not in before:
                root.removeHandler(h)
                h.close()
        root.setLevel(level)
    assert any("scenario greedy_x_p4_s0 failed" in r.getMessage() for r in caplog.records)


# -- JSON logging --------------------------------------------------------------


def test_setup_logging_is_idempotent_and_additive(tmp_path):
    root = logging.getLogger("tnc_tpu_torch")
    before, level = list(root.handlers), root.level
    app = logging.NullHandler()
    root.addHandler(app)
    try:
        logging_util.setup_logging(tmp_path)
        logging_util.setup_logging(tmp_path)
        ours = [h for h in root.handlers if getattr(h, "_tnc_tpu_bench", False)]
        assert len(ours) == 2 and app in root.handlers
        logging.getLogger("tnc_tpu_torch.benchmark").info("hello", extra={"cell": "c1"})
        files = list(tmp_path.glob("benchmark_pid*.jsonl"))
        assert [f.name for f in files] == [f"benchmark_pid{os.getpid()}.jsonl"]
        rec = json.loads(files[0].read_text().splitlines()[-1])
        assert rec["msg"] == "hello" and rec["cell"] == "c1" and rec["level"] == "INFO"
        assert rec["logger"] == "tnc_tpu_torch.benchmark"
    finally:
        for h in root.handlers[:]:
            if h not in before:
                root.removeHandler(h)
                h.close()
        root.setLevel(level)


def test_json_formatter_matches_the_references():
    from tnc_tpu.benchmark.logging_util import JsonFormatter as RefFormatter

    rec = logging.LogRecord("tnc_tpu_torch.x", logging.WARNING, "f.py", 3, "a %s", ("b",), None)
    rec.extra_field = {"k": 1}
    port = json.loads(logging_util.JsonFormatter().format(rec))
    ref = json.loads(RefFormatter().format(rec))
    assert port.pop("ts") and ref.pop("ts")
    assert port == ref


def test_discriminant_under_a_process_group(monkeypatch):
    """``proc{rank}`` when ``obs.core.process_identity`` reports a group of
    several processes, else ``pid{pid}``."""
    from tnc_tpu_torch.obs import core

    assert logging_util.process_discriminant() == f"pid{os.getpid()}"
    monkeypatch.setattr(core, "process_identity", lambda: (4, 3))
    assert logging_util.process_discriminant() == "proc3"


# -- the CLI end to end, in subprocesses ---------------------------------------


def test_cli_sweep_then_run_on_the_host(tmp_path):
    """``sweep`` then ``run`` under ``TNC_TPU_PLATFORM=cpu`` (TorchBackend on
    the host): complete outputs, no ERROR record, a second sweep skipping;
    the artifact loaded here contracts to the reference's statevector."""
    text = circuit_text(10, 11)
    (tmp_path / "c").mkdir()
    (tmp_path / "c" / "c10.qasm").write_text(text)
    env = dict(os.environ, TNC_TPU_PLATFORM="cpu",
               PYTHONPATH=os.pathsep.join([str(REPO)] + [p for p in [os.environ.get(
                   "PYTHONPATH")] if p]))
    common = ["--circuits-dir", str(tmp_path / "c"), "--cache-dir", str(tmp_path / "cache"),
              "--out", str(tmp_path / "r.jsonl"), "--protocol", str(tmp_path / "p.jsonl"),
              "--log-dir", str(tmp_path / "logs"), "--methods", "greedy", "tree-temper",
              "--partitions", "2"]
    for mode in ("sweep", "run", "sweep"):
        extra = ["--repeats", "2"] if mode == "run" else []
        subprocess.run([sys.executable, "-m", "tnc_tpu_torch.benchmark", mode, *common, *extra],
                       cwd=str(REPO), env=env, check=True, capture_output=True, timeout=300)
    records = ResultWriter(tmp_path / "r.jsonl").read_all()
    assert sorted((r["kind"], r["method"]) for r in records) == [
        ("OptimizationResult", "greedy"), ("OptimizationResult", "tree-temper"),
        ("RunResult", "greedy"), ("RunResult", "tree-temper")]
    assert all(r["backend"] == "torch" and r["time_to_solution"] > 0
               for r in records if r["kind"] == "RunResult")
    proto = Protocol(tmp_path / "p.jsonl")
    assert len(proto.completed) == 4 and not proto.failed
    logs = [json.loads(line) for f in (tmp_path / "logs").iterdir()
            for line in f.read_text().splitlines()]
    assert not [r for r in logs if r["level"] == "ERROR"]
    assert sum(r["msg"].startswith("skipping sweep/") for r in logs) == 2

    ref_tn, ref_perm = ref_import(text).into_statevector_network()
    want = ref_contract(ref_tn, RefGreedy(RefOptMethod.GREEDY).find_path(ref_tn).replace_path(),
                        "numpy")
    for method in ("greedy", "tree-temper"):
        tn, path = ArtifactCache(tmp_path / "cache").load(Scenario("c10", text, 2, 0, method).key())
        got = contract_tensor_network(tn, path, TorchBackend(device="cpu"))
        order = [list(got.legs).index(leg) for leg in want.legs]
        np.testing.assert_allclose(np.transpose(got.data.into_data(), order),
                                   want.data.into_data(), rtol=0, atol=SV_TOL)


@pytest.mark.parametrize("module", [results, protocol, cache_mod, logging_util, methods, driver])
def test_doctests(module):
    import doctest

    assert doctest.testmod(module).failed == 0
