"""OpenQASM 2.0 → Circuit importer (the port's copy of
``tnc_tpu.io.qasm.importer``).

Include expansion (with the standard ``qelib1.inc`` embedded), parse
(:mod:`tnc_tpu_torch.io.qasm.grammar`, a recursive-descent parser that
needs nothing beyond the standard library), then recursive evaluation:
user-defined gate calls are expanded with a numeric parameter environment,
so constant folding happens at substitution time, down to registry
built-ins, with QASM register broadcasting at the top level. A gate call
whose (lowercased) name is in the gate registry is emitted directly and
never inlined.

Unsupported (as in the reference): ``measure``, ``reset``, ``if``,
classical ops. ``barrier`` is a no-op. The evaluation and every
:class:`QasmError` message are the reference's; a parse error keeps the
reference's ``"QASM parse error: "`` prefix and names the line, column
and the token expected.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from pathlib import Path

from tnc_tpu_torch.builders.circuit_builder import Circuit, Qubit
from tnc_tpu_torch.gates import gate_arity, is_gate_known
from tnc_tpu_torch.io.qasm.grammar import (
    GateCall,
    GateDecl,
    Keyword,
    Opaque,
    Register,
    parse,
)
from tnc_tpu_torch.io.qasm.qelib1 import QELIB1
from tnc_tpu_torch.tensornetwork.tensordata import TensorData


class QasmError(ValueError):
    """Raised on unsupported or malformed QASM input."""


_FUNCS = {
    "sin": math.sin,
    "cos": math.cos,
    "tan": math.tan,
    "exp": math.exp,
    "ln": math.log,
    "sqrt": math.sqrt,
}

_BINARY = {
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b,
    "div": lambda a, b: a / b,
    "pow": lambda a, b: a**b,
}


def _eval_expr(node: tuple, env: dict[str, float]) -> float:
    """Numeric evaluation of a parameter expression tree
    (:class:`~tnc_tpu_torch.io.qasm.grammar.GateCall`'s ``exprs``), left
    operand first.

    >>> _eval_expr(("div", ("neg", ("pi",)), ("number", "2")), {}) == -math.pi / 2
    True
    """
    kind = node[0]
    if kind == "number":
        return float(node[1])
    if kind == "pi":
        return math.pi
    if kind == "name":
        name = node[1]
        if name not in env:
            raise QasmError(f"Unknown parameter '{name}' in expression")
        return env[name]
    if kind == "func":
        return _FUNCS[node[1]](_eval_expr(node[2], env))
    if kind == "neg":
        return -_eval_expr(node[1], env)
    if kind in _BINARY:
        left = _eval_expr(node[1], env)
        return _BINARY[kind](left, _eval_expr(node[2], env))
    raise QasmError(f"Unsupported expression node '{kind}'")


@dataclass
class _GateDef:
    params: list[str]
    qubit_args: list[str]
    body: list[GateCall]


class _Importer:
    def __init__(self, include_dir: Path | None = None) -> None:
        self.circuit = Circuit()
        self.registers: dict[str, object] = {}
        self.gate_defs: dict[str, _GateDef] = {}
        self.include_dir = include_dir

    # -- include expansion --------------------------------------------------

    def expand_includes(self, code: str, depth: int = 0) -> str:
        if depth > 16:
            raise QasmError("Include depth exceeded (cycle?)")
        out_lines = []
        for line in code.splitlines():
            stripped = line.strip()
            if stripped.startswith("include"):
                path = stripped.split('"')[1]
                if path == "qelib1.inc":
                    included = QELIB1
                else:
                    if self.include_dir is None:
                        raise QasmError(
                            f"Cannot resolve include '{path}' without an include dir"
                        )
                    included = (self.include_dir / path).read_text()
                out_lines.append(self.expand_includes(included, depth + 1))
            else:
                out_lines.append(line)
        return "\n".join(out_lines)

    # -- statement handling -------------------------------------------------

    def run(self, code: str) -> Circuit:
        code = self.expand_includes(code)
        try:
            statements = parse(code)
        except Exception as exc:  # syntax errors -> QasmError
            raise QasmError(f"QASM parse error: {exc}") from exc
        for stmt in statements:
            self._statement(stmt)
        return self.circuit

    def _statement(self, stmt) -> None:
        if isinstance(stmt, Register):
            if stmt.kind == "creg":
                return  # tolerated, unused
            if stmt.name in self.registers:
                raise QasmError(f"Register '{stmt.name}' redeclared")
            self.registers[stmt.name] = self.circuit.allocate_register(stmt.size)
            return
        if isinstance(stmt, GateDecl):
            self.gate_defs[stmt.name] = _GateDef(
                list(stmt.params), list(stmt.qubits), list(stmt.body)
            )
            return
        if isinstance(stmt, Opaque):
            if not is_gate_known(stmt.name.lower()):
                raise QasmError(f"Opaque gate '{stmt.name}' is not a known gate")
            return
        if isinstance(stmt, GateCall):
            self._toplevel_gate_call(stmt)
            return
        keyword = stmt.keyword
        if keyword == "include":
            raise QasmError("Unexpanded include found after expansion")
        if keyword == "barrier":
            return
        raise QasmError(f"'{keyword}' is not supported")

    # -- gate call resolution -----------------------------------------------

    def _toplevel_gate_call(self, call: GateCall) -> None:
        angles = [_eval_expr(e, {}) for e in call.exprs]

        # QASM broadcasting: full-register args apply the gate per element
        resolved: list[list[Qubit]] = []
        broadcast_len: int | None = None
        for arg in call.args:
            if arg.name not in self.registers:
                raise QasmError(f"Unknown register '{arg.name}'")
            register = self.registers[arg.name]
            if arg.index is not None:
                resolved.append([register.qubit(arg.index)])
            else:
                resolved.append(list(register.qubits()))
                if broadcast_len is None:
                    broadcast_len = len(register)
                elif broadcast_len != len(register):
                    raise QasmError("Mismatched register sizes in broadcast")

        n = broadcast_len if broadcast_len is not None else 1
        for k in range(n):
            qubits = [(qs[0] if len(qs) == 1 else qs[k]) for qs in resolved]
            self._apply(call.name, angles, qubits)

    def _apply(
        self, name: str, angles: list[float], qubits: list[Qubit], depth: int = 0
    ) -> None:
        if depth > 64:
            raise QasmError(
                f"Gate inlining exceeded depth 64 at '{name}' (recursive definition?)"
            )
        lname = name.lower()
        if is_gate_known(lname):
            arity = gate_arity(lname)
            if arity is not None and arity != len(qubits):
                raise QasmError(
                    f"Gate '{name}' expects {arity} qubits, got {len(qubits)}"
                )
            self.circuit.append_gate(TensorData.gate(lname, tuple(angles)), qubits)
            return
        if name not in self.gate_defs:
            raise QasmError(f"Unknown gate '{name}'")
        gate = self.gate_defs[name]
        if len(gate.params) != len(angles):
            raise QasmError(
                f"Gate '{name}' expects {len(gate.params)} params, got {len(angles)}"
            )
        if len(gate.qubit_args) != len(qubits):
            raise QasmError(
                f"Gate '{name}' expects {len(gate.qubit_args)} qubits, got {len(qubits)}"
            )
        env = dict(zip(gate.params, angles))
        qubit_env = dict(zip(gate.qubit_args, qubits))
        for call in gate.body:
            sub_angles = [_eval_expr(e, env) for e in call.exprs]
            sub_qubits = []
            for arg in call.args:
                if arg.name not in qubit_env:
                    raise QasmError(f"Unknown qubit '{arg.name}' in gate '{name}'")
                sub_qubits.append(qubit_env[arg.name])
            self._apply(call.name, sub_angles, sub_qubits, depth + 1)


def import_qasm(code: str, include_dir: str | Path | None = None) -> Circuit:
    """Create a :class:`Circuit` from OpenQASM 2.0 source.

    >>> c = import_qasm('''OPENQASM 2.0;
    ... include "qelib1.inc";
    ... qreg q[2];
    ... h q[0];
    ... cx q[0], q[1];''')
    >>> tn, _ = c.into_statevector_network()
    >>> len(tn)   # 2 kets + 2 gates
    4
    """
    importer = _Importer(Path(include_dir) if include_dir else None)
    return importer.run(code)
