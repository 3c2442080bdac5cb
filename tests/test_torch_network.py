"""The port's host layers against the JAX package's: identical networks,
paths, programs, chains and kernel policies from the same seeds.

``tnc_tpu_torch`` keeps its own copies of the builders, the greedy path
finder, the program compiler and the kernel policy; these tests pin the
copies to the reference so both packages contract the same network
through the same steps.
"""

import dataclasses
import importlib

import numpy as np
import pytest

import tnc_tpu.builders.circuit_builder as ref_cb
import tnc_tpu.builders.connectivity as ref_conn
import tnc_tpu.contractionpath.paths as ref_paths
import tnc_tpu.ops.program as ref_prog
import tnc_tpu.ops.split_complex as ref_sc
import tnc_tpu.tensornetwork.tensordata as ref_td
import tnc_tpu_torch.builders.circuit_builder as port_cb
import tnc_tpu_torch.builders.connectivity as port_conn
import tnc_tpu_torch.contractionpath.paths as port_paths
import tnc_tpu_torch.ops.program as port_prog
import tnc_tpu_torch.ops.split_complex as port_sc
import tnc_tpu_torch.tensornetwork.tensordata as port_td
from tnc_tpu_torch.interop import network_from_arrays, path_from_pairs

# ``tnc_tpu.builders`` (and, as the reference does, ``tnc_tpu_torch.builders``)
# re-exports a function of the module's own name
ref_rc = importlib.import_module("tnc_tpu.builders.random_circuit")
port_rc = importlib.import_module("tnc_tpu_torch.builders.random_circuit")

LAYOUTS = ["SYCAMORE", "LINE", "ALL"]


def _random(pkg_rc, pkg_conn, qubits, seed, layout="SYCAMORE", depth=12):
    return pkg_rc.random_circuit(
        qubits, depth, 0.4, 0.4, np.random.default_rng(seed),
        getattr(pkg_conn.ConnectivityLayout, layout), bitstring="*" * qubits,
    )


def _ghz(cb, td, qubits, bitstring=None):
    c = cb.Circuit()
    reg = c.allocate_register(qubits)
    c.append_gate(td.TensorData.gate("h"), [reg.qubit(0)])
    for i in range(qubits - 1):
        c.append_gate(td.TensorData.gate("cx"), [reg.qubit(i), reg.qubit(i + 1)])
    return c.into_amplitude_network(bitstring or "*" * qubits)[0]


def _leaves(prog_mod, tn):
    return [
        (list(l.legs), list(l.bond_dims), np.asarray(l.data.into_data()))
        for l in prog_mod.flat_leaf_tensors(tn)
    ]


def _assert_same_leaves(a, b):
    assert len(a) == len(b)
    for (la, da, xa), (lb, db, xb) in zip(a, b):
        assert la == lb and da == db
        assert xa.dtype == xb.dtype == np.complex128
        assert np.array_equal(xa, xb)


def _pair(qubits, seed, layout="SYCAMORE"):
    ref = _random(ref_rc, ref_conn, qubits, seed, layout)
    port = _random(port_rc, port_conn, qubits, seed, layout)
    return ref, port


def _steps(program):
    return [dataclasses.astuple(st) for st in program.steps]


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("seed", [0, 42])
def test_random_circuit_leaves_identical(layout, seed):
    ref, port = _pair(9, seed, layout)
    _assert_same_leaves(_leaves(ref_prog, ref), _leaves(port_prog, port))


@pytest.mark.parametrize("bitstring", [None, "101101", "1*0*1*"])
def test_ghz_leaves_identical(bitstring):
    ref = _ghz(ref_cb, ref_td, 6, bitstring)
    port = _ghz(port_cb, port_td, 6, bitstring)
    _assert_same_leaves(_leaves(ref_prog, ref), _leaves(port_prog, port))


def test_connectivity_tables_identical():
    for layout in port_conn.ConnectivityLayout:
        n = 12 if layout.name in ("ALL", "LINE") else None
        ref = ref_conn.Connectivity.new(getattr(ref_conn.ConnectivityLayout, layout.name), n)
        port = port_conn.Connectivity.new(layout, n)
        assert ref.connectivity == port.connectivity


@pytest.mark.parametrize("qubits,seed", [(10, 42), (12, 42), (8, 3)])
def test_greedy_path_identical(qubits, seed):
    ref, port = _pair(qubits, seed)
    r = ref_paths.Greedy(ref_paths.OptMethod.GREEDY).find_path(ref)
    p = port_paths.Greedy(port_paths.OptMethod.GREEDY).find_path(port)
    assert r.replace_path().toplevel == p.replace_path().toplevel
    assert (r.flops, r.size) == (p.flops, p.size)


def test_random_greedy_path_identical():
    ref, port = _pair(8, 5)
    r = ref_paths.Greedy(ref_paths.OptMethod.RANDOM_GREEDY, ntrials=4).find_path(ref)
    p = port_paths.Greedy(port_paths.OptMethod.RANDOM_GREEDY, ntrials=4).find_path(port)
    assert r.ssa_path.toplevel == p.ssa_path.toplevel


def _programs(qubits, seed=42):
    ref, port = _pair(qubits, seed)
    path = ref_paths.Greedy(ref_paths.OptMethod.GREEDY).find_path(ref).replace_path()
    ref_program = ref_prog.build_program(ref, path)
    port_program = port_prog.build_program(port, path_from_pairs(path.toplevel))
    return ref_program, port_program


@pytest.mark.parametrize("qubits", [10, 12])
def test_build_program_identical(qubits):
    r, p = _programs(qubits)
    assert _steps(r) == _steps(p)
    assert (r.num_inputs, r.result_slot, r.result_legs, r.result_shape) == (
        p.num_inputs, p.result_slot, p.result_legs, p.result_shape,
    )
    assert r.canonical_legs == p.canonical_legs
    assert r.stored_result_shape == p.stored_result_shape


def test_chain_groups_identical_and_counted():
    """At 10 and at 12 qubits the reference's chain grouping finds 8
    chains; the port's copy must find the same spans."""
    for qubits, want in ((10, 8), (12, 8)):
        r, p = _programs(qubits)
        ref_chains = ref_prog.chain_groups(r.steps)
        assert port_prog.chain_groups(p.steps) == ref_chains
        assert len(ref_chains) == want
        # explicit bounds take the same arguments
        assert port_prog.chain_groups(p.steps, max_elems=64.0) == ref_prog.chain_groups(
            r.steps, max_elems=64.0
        )


@pytest.mark.parametrize(
    "force", [None, "auto", "chain", "naive", "gauss", "fused", "strassen"]
)
def test_plan_kernels_identical(force, monkeypatch):
    if force is None:
        monkeypatch.delenv("TNC_TPU_COMPLEX_MULT", raising=False)
    else:
        monkeypatch.setenv("TNC_TPU_COMPLEX_MULT", force)
    r, p = _programs(10)
    rp = ref_sc.plan_kernels(r)
    pp = port_sc.plan_kernels(p)
    assert rp.modes == pp.modes
    assert rp.chains == pp.chains
    assert rp.precision_modes == pp.precision_modes
    assert rp.dispatch_count() == pp.dispatch_count()


@pytest.mark.parametrize("rung", ["high", "highest"])
def test_precision_override_identical(rung, monkeypatch):
    monkeypatch.setenv("TNC_TPU_DOT_PRECISION", rung)
    r, p = _programs(10)
    assert ref_sc.plan_kernels(r).precision_modes == port_sc.plan_kernels(p).precision_modes


def test_step_buckets_and_summary_identical():
    r, p = _programs(10)
    assert [ref_sc.step_bucket(s) for s in r.steps] == [
        port_sc.step_bucket(s) for s in p.steps
    ]
    rs = ref_sc.kernel_plan_summary(r)
    ps = port_sc.kernel_plan_summary(p)
    for key in ("dispatches", "chains", "chained_steps"):
        assert rs[key] == ps[key]
    for bucket, row in rs["buckets"].items():
        prow = ps["buckets"][bucket]
        assert (row["steps"], row["modes"], row["transpose_steps"]) == (
            prow["steps"], prow["modes"], prow["transpose_steps"],
        )
        assert prow["flops"] == pytest.approx(row["flops"], rel=1e-3)


def test_interop_rebuilds_the_reference_network():
    """``network_from_arrays`` + ``path_from_pairs`` carry the reference's
    leaves and path across: the port compiles the identical program."""
    ref = _random(ref_rc, ref_conn, 9, 7)
    path = ref_paths.Greedy(ref_paths.OptMethod.GREEDY).find_path(ref).replace_path()
    tn = network_from_arrays(_leaves(ref_prog, ref))
    program = port_prog.build_program(tn, path_from_pairs(path.toplevel))
    assert _steps(program) == _steps(ref_prog.build_program(ref, path))
    _assert_same_leaves(_leaves(port_prog, tn), _leaves(ref_prog, ref))
    with pytest.raises(ValueError, match="bond dims"):
        network_from_arrays([([0], [3], np.zeros(2))])


def test_gate_library_identical():
    import tnc_tpu.gates as ref_gates
    import tnc_tpu_torch.gates as port_gates

    assert ref_gates.gate_names() == port_gates.gate_names()
    angles = {"u": (0.3, 0.2, 0.1), "rx": (0.7,), "ry": (0.7,), "rz": (0.7,),
              "cp": (0.4,), "fsim": (0.3, 0.2)}
    for name in port_gates.gate_names():
        a = angles.get(name, ())
        assert np.array_equal(ref_gates.load_gate(name, a), port_gates.load_gate(name, a))
        assert np.array_equal(
            ref_gates.load_gate_adjoint(name, a), port_gates.load_gate_adjoint(name, a)
        )
