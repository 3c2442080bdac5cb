"""The port's OpenQASM 2.0 importer (``tnc_tpu_torch.io.qasm``, a
recursive-descent parser) against the reference's
(``tnc_tpu.io.qasm``) on the CPU: the same network leaf by leaf (legs,
bond dims, gate name, angles bitwise, adjoint) over a corpus — every
source of ``tests/test_qasm.py``, every qelib1 gate once with parameters,
50 seeded random circuits with user gates, register broadcasts, comments
and ``barrier``, the parser's edge cases, and the circuits
``chip_smoke.py`` phase 19 writes — few-qubit statevectors within 1e-12 of
the reference's numpy contraction, and every error case with the
reference's ``QasmError`` message (a parse error: the same
``"QASM parse error: "`` prefix)."""

import ast
import math
import pathlib

import numpy as np
import pytest

from tnc_tpu.contractionpath.paths import Greedy as RefGreedy
from tnc_tpu.contractionpath.paths import OptMethod as RefOptMethod
from tnc_tpu.io.qasm import import_qasm as ref_import
from tnc_tpu.io.qasm.importer import QasmError as RefQasmError
from tnc_tpu.tensornetwork.contraction import contract_tensor_network as ref_contract
from tnc_tpu_torch.contractionpath.paths import Greedy, OptMethod
from tnc_tpu_torch.io.qasm import grammar, import_qasm, importer, qelib1
from tnc_tpu_torch.io.qasm.importer import QasmError
from tnc_tpu_torch.tensornetwork.contraction import contract_tensor_network

REPO = pathlib.Path(__file__).resolve().parents[1]

SV_TOL = 1e-12  # complex128 statevectors of both packages' numpy contractions


def leaves(circuit) -> list:
    """A circuit's network as plain tuples: legs, bond dims, and the payload
    (gate name, angles, adjoint; or the matrix's bytes)."""
    out = []
    for t in circuit.tensor_network.tensors:
        kind = t.data.kind.name
        payload = t.data.payload if kind == "GATE" else t.data.into_data().tobytes()
        out.append((tuple(t.legs), tuple(t.bond_dims), kind, payload))
    return out


def assert_same_network(code: str) -> None:
    port, ref = leaves(import_qasm(code)), leaves(ref_import(code))
    assert len(port) == len(ref)
    for a, b in zip(port, ref):
        assert a == b


def statevectors(code: str):
    """The statevector of ``code`` by each package's numpy contraction, in
    the reference's leg order."""
    port_tn, port_perm = import_qasm(code).into_statevector_network()
    ref_tn, ref_perm = ref_import(code).into_statevector_network()
    port_out = port_perm.apply(contract_tensor_network(
        port_tn, Greedy(OptMethod.GREEDY).find_path(port_tn).replace_path(), "numpy"))
    ref_out = ref_perm.apply(ref_contract(
        ref_tn, RefGreedy(RefOptMethod.GREEDY).find_path(ref_tn).replace_path(), "numpy"))
    return np.asarray(port_out.data.into_data()), np.asarray(ref_out.data.into_data())


# -- the corpus ---------------------------------------------------------------


def reference_test_sources() -> list[str]:
    """Every QASM source of ``tests/test_qasm.py``: its string constants that
    declare a register, and its three unsupported-statement programs."""
    tree = ast.parse((REPO / "tests" / "test_qasm.py").read_text())
    found = [node.value for node in ast.walk(tree)
             if isinstance(node, ast.Constant) and isinstance(node.value, str)
             and "qreg" in node.value]
    for snippet in ("measure q[0] -> c[0];", "reset q[0];", "if (c == 1) x q[0];"):
        found.append(f'OPENQASM 2.0;\ninclude "qelib1.inc";\nqreg q[1];\ncreg c[1];\n{snippet}\n')
    return found


def qelib1_program() -> str:
    """Every gate qelib1 declares, called once with parameters on distinct
    qubits of a 5-qubit register."""
    lines = ['OPENQASM 2.0;', 'include "qelib1.inc";', 'qreg q[5];']
    decls = [s for s in grammar.parse(qelib1.QELIB1) if isinstance(s, grammar.GateDecl)]
    for k, decl in enumerate(decls):
        params = ", ".join(f"{0.1 * (k + 1) + 0.07 * j!r}" for j in range(len(decl.params)))
        args = ", ".join(f"q[{(k + j) % 5}]" for j in range(len(decl.qubits)))
        lines.append(f"{decl.name}({params}) {args};" if decl.params else f"{decl.name} {args};")
    return "\n".join(lines)


def random_program(seed: int) -> str:
    """A seeded random circuit over two registers: user gates with parameter
    expressions (nested, calling qelib1 and registry gates), register
    broadcasts, comments and ``barrier``."""
    rng = np.random.default_rng(seed)
    n_a, n_b = int(rng.integers(1, 4)), int(rng.integers(1, 4))
    lines = ["// random program " + str(seed), "OPENQASM 2.0;", 'include "qelib1.inc";',
             "gate rot(a, b) q { rz(a*2 - b) q; rx(-a/3 + b^2) q; // inner comment",
             "  ry(+(a - pi)/4) q; barrier q; }",
             "gate ent(t) c, d { cx c, d; rot(t, -t) d; cp(t^2*pi) c, d; }",
             "gate pair c, d { fsim(0.3, 0.2) c, d; cz d, c; }",
             f"qreg a[{n_a}];", f"qreg b[{n_b}];", f"creg m[{n_a}];"]

    def num() -> str:
        x = float(rng.uniform(-3.0, 3.0))
        return (repr(x), f"pi/{int(rng.integers(1, 9))}", f"-{abs(x):.3f}",
                f"{abs(x):.2e}", f"({x!r})^2", f"2*pi - {abs(x)!r}")[int(rng.integers(0, 6))]

    def qubit() -> str:
        reg, n = ("a", n_a) if rng.random() < 0.5 else ("b", n_b)
        return f"{reg}[{int(rng.integers(0, n))}]"

    for _ in range(int(rng.integers(5, 15))):
        kind = int(rng.integers(0, 9))
        if kind == 0:
            lines.append(f"h {('a', 'b')[int(rng.integers(0, 2))]};  // broadcast")
        elif kind == 1 and n_a == n_b:
            lines.append("ent(" + num() + ") a, b;")
        elif kind == 2:
            lines.append(f"u3({num()}, {num()}, {num()}) {qubit()};")
        elif kind == 3:
            lines.append(f"rot({num()}, {num()}) {qubit()};")
        elif kind == 4:
            lines.append(f"barrier a, {qubit()};")
        elif kind == 5:
            lines.append(f"{('sx', 'sy', 'sz', 't', 's', 'tdg', 'x', 'z')[int(rng.integers(0, 8))]} "
                         f"{qubit()};")
        else:
            c, t = qubit(), qubit()
            if c != t:
                gate = ("cx", "pair", "swap", "crz(" + num() + ")", "rzz(" + num() + ")",
                        "U(" + num() + ", 0, pi)")[int(rng.integers(0, 6))]
                lines.append(f"{gate} {c}, {t};" if not gate.startswith("U(") else
                             f"{gate} {c};")
    return "\n".join(lines) + "\n"


def phase19_sources() -> list[str]:
    """The two circuits ``chip_smoke.py`` phase 19 writes (28 and 24
    qubits)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return [smoke.qasm_text(name, qubits, smoke.QASM_ROUNDS)
            for name, qubits, _, _ in smoke.QASM_CELLS]


# programs both parsers accept or reject alike: keyword names in their
# contextual places, numbers, unary signs, powers, bodies
EDGE_CASES = [
    "qreg pi[1]; rx(pi) pi[0];",
    "gate g(sin) q { rx(sin) q; } qreg q[1]; g(0.3) q[0];",
    "gate g(pi) q { rx(pi) q; } qreg q[1]; g(0.3) q[0];",
    "qreg gate[1]; x gate[0];",
    "qreg U[1]; U(0,0,0) U[0];",
    "qreg CX[2]; CX CX[0], CX[1];",
    "OPENQASM 2.0; OPENQASM 2.0;",
    "gate g q { measure q; } qreg q[1]; g q[0];",
    "gate g q { qreg q; } qreg q[1]; g q[0];",
    "qreg q[1]; creg c[1]; if (c==1) measure q[0];",
    "qreg if[1]; x if[0];",
    "gate g(U) q { rx(U) q; } qreg q[1]; g(0.3) q[0];",
    "gate barrier q { x q; }",
    "gate pi q { x q; } qreg q[1]; pi q[0];",
    "gate sin q { x q; } qreg q[1]; sin q[0];",
    "qreg q[1]; u(0,0,0) q[0];",
    "OPENQASM 3; qreg q[1];",
    "OPENQASM .5; qreg q[1];",
    "",
    "// only a comment",
    "opaque fsim(a,b) p, q;",
    "opaque nothing(a) p;",
    "qreg q[1]; pi(1) q[0];",
    "qreg sqrt[1]; x sqrt[0];",
    "qreg q[1]; rx(1e-3) q[0];",
    "qreg q[1]; rx(.5) q[0];",
    "qreg q[1]; rx(5.) q[0];",
    "qreg q[1]; rx(2.e1) q[0];",
    "qreg q[1]; rx(+-+0.5) q[0];",
    "qreg q[1]; rx(2^3^-1) q[0];",
    "qreg q[1]; rx(-2^2*3/4-1) q[0];",
    "qreg q[1]; rx(2--3) q[0];",
    "qreg q[1]; x() q[0];",
    "gate g() q { x q; } qreg q[1]; g q[0];",
    "qreg q[1]; include \"qelib1.inc\";",
    "qreg q[1]; x \"q\";",
    "qreg q[1]; measure q -> c;",
    "qreg q[1]; reset q;",
    "gate g q { barrier q; x q; } qreg q[1]; g q[0];",
    "gate g q { x q[0]; } qreg q[1]; g q[0];",
    "qreg q[1]; if (gate==1) x q[0];",
    "qreg q[1];if(c==1)x q[0];",
    "qreg q[2]; cx q[0];",
    "qreg q[2]; cx q[0], q[1], q[0];",
    "qreg q[1]; rx(a) q[0];",
    "qreg q[1]; qreg q[2];",
    "qreg q[1]; x r[0];",
    "gate g(a) q { rx(a) q; } qreg q[1]; g q[0];",
    "gate g q { x q; } qreg q[2]; g q[0], q[1];",
    "gate g q { x r; } qreg q[1]; g q[0];",
    "gate g q { g q; } qreg q[1]; g q[0];",
    "qreg a[2]; qreg b[3]; CX a, b;",
    "qreg q[1]; rx(1/0) q[0];",
    "qreg q[2]; rx(0.1) q;",
    "qreg q[1]; x q[0]",
    "qreg q[1; x q[0];",
    "qreg q[1.0];",
    "qreg q[1e3];",
    "qreg q[1]; rx(1e) q[0];",
    "qreg q[1]; rx(2pi) q[0];",
    "qreg q[1]; x q[0]; }",
    "qreg q[1]; @ x q[0];",
    "gate g q { x q; ",
    "gate g q x q; }",
    "qreg q[1]; x q[0], ;",
    "qreg q[1]; rx(,) q[0];",
    "qreg q[1]; rx((0.5) q[0];",
    "include \"nowhere.inc\";",
]


def outcome(fn, code):
    """``("ok", leaves)``, or the error: a parse error by its prefix alone
    (the two parsers word the detail differently), any other exception by
    its type and message."""
    try:
        return ("ok", leaves(fn(code)))
    except (QasmError, RefQasmError) as e:
        msg = str(e)
        return ("QasmError", "QASM parse error" if msg.startswith("QASM parse error: ") else msg)
    except Exception as e:  # noqa: BLE001 — both packages must raise the same thing
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("index", range(len(reference_test_sources())))
def test_reference_test_sources(index):
    code = reference_test_sources()[index]
    assert outcome(import_qasm, code) == outcome(ref_import, code)


def test_every_qelib1_gate_with_parameters():
    code = qelib1_program()
    assert len([s for s in grammar.parse(qelib1.QELIB1) if isinstance(s, grammar.GateDecl)]) > 40
    assert_same_network(code)


@pytest.mark.parametrize("seed", range(50))
def test_random_programs(seed):
    code = random_program(seed)
    assert outcome(import_qasm, code) == outcome(ref_import, code)
    assert outcome(import_qasm, code)[0] == "ok"


@pytest.mark.parametrize("seed", range(0, 50, 5))
def test_random_program_statevectors(seed):
    """Few-qubit statevectors (at most 6 qubits) within 1e-12 of the
    reference's numpy contraction."""
    port, ref = statevectors(random_program(seed))
    assert port.shape == ref.shape
    np.testing.assert_allclose(port, ref, rtol=0, atol=SV_TOL)
    assert abs(np.vdot(port.ravel(), port.ravel()).real - 1.0) <= 1e-12


def test_qelib1_statevector():
    port, ref = statevectors(qelib1_program())
    np.testing.assert_allclose(port, ref, rtol=0, atol=SV_TOL)


@pytest.mark.parametrize("index", range(len(EDGE_CASES)))
def test_edge_cases(index):
    code = EDGE_CASES[index]
    assert outcome(import_qasm, code) == outcome(ref_import, code)


def test_error_messages_are_the_references():
    """Each semantic error raises QasmError with the reference's words."""
    messages = {outcome(import_qasm, code)[1] for code in EDGE_CASES
                if outcome(import_qasm, code)[0] == "QasmError"}
    for expected in ("'measure' is not supported", "'reset' is not supported",
                     "'if' is not supported", "Unknown gate 'measure'",
                     "Gate 'cx' expects 2 qubits, got 1", "Unknown parameter 'a' in expression",
                     "Register 'q' redeclared", "Unknown register 'r'",
                     "Gate 'g' expects 1 params, got 0", "Gate 'g' expects 1 qubits, got 2",
                     "Unknown qubit 'r' in gate 'g'", "Mismatched register sizes in broadcast",
                     "Gate inlining exceeded depth 64 at 'g' (recursive definition?)",
                     "Unexpanded include found after expansion",
                     "Opaque gate 'nothing' is not a known gate",
                     "Cannot resolve include 'nowhere.inc' without an include dir",
                     "QASM parse error"):
        assert expected in messages, expected


@pytest.mark.parametrize("index", range(2))
def test_chip_smoke_circuits(index):
    """The 28- and 24-qubit circuits chip_smoke.py phase 19 writes import to
    the reference's network (no contraction here)."""
    code = phase19_sources()[index]
    assert "gate zxz(a, b)" in code and "h q;" in code and "barrier q;" in code
    assert_same_network(code)


def test_include_dir(tmp_path):
    (tmp_path / "mine.inc").write_text("gate myh a { h a; }\n")
    code = 'OPENQASM 2.0;\ninclude "mine.inc";\nqreg q[1];\nmyh q[0];\n'
    port = leaves(import_qasm(code, include_dir=tmp_path))
    assert port == leaves(ref_import(code, include_dir=tmp_path))
    assert port[-1][2:] == ("GATE", ("h", (), False))


def test_function_calls_evaluate():
    """The grammar's functions parse in the port (the reference's lexer
    reads ``sin`` as a name before ``(`` and rejects every call: a recorded
    divergence) and fold to ``math``'s values."""
    code = "qreg q[1]; U(sin(0.5), cos(-1)+tan(0.25)*2, exp(1)-ln(2)^sqrt(3)) q[0];"
    (leaf,) = [t for t in leaves(import_qasm(code)) if t[2] == "GATE"]
    assert leaf[3] == ("u", (math.sin(0.5), math.cos(-1) + math.tan(0.25) * 2,
                             math.exp(1) - math.log(2) ** math.sqrt(3)), False)
    with pytest.raises(RefQasmError, match="parse error"):
        ref_import(code)


def test_parse_error_names_the_place():
    with pytest.raises(QasmError, match=r"QASM parse error: line 2, column 8: expected an "
                                        r"integer, got end of input"):
        import_qasm("OPENQASM 2.0;\nqreg q[")


def test_no_lark_in_the_port():
    """No module of ``tnc_tpu_torch/io/`` imports lark (the card's machine
    has none), and the word appears nowhere in the port."""
    for path in (REPO / "tnc_tpu_torch" / "io").rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                assert all(not a.name.split(".")[0] == "lark" for a in node.names), path
            if isinstance(node, ast.ImportFrom):
                assert (node.module or "").split(".")[0] != "lark", path
    for path in (REPO / "tnc_tpu_torch").rglob("*.py"):
        assert "lark" not in path.read_text().lower(), path


@pytest.mark.parametrize("module", [grammar, importer, qelib1])
def test_doctests(module):
    import doctest

    assert doctest.testmod(module).failed == 0
