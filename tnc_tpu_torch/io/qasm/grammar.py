"""OpenQASM 2.0 grammar: a tokenizer and a recursive-descent parser.

The language is the reference's supported subset (``tnc_tpu.io.qasm.
grammar.QASM2_GRAMMAR``), written out below as :data:`QASM2_GRAMMAR`: the
version header, ``include``, ``qreg`` and ``creg``, ``gate`` and ``opaque``
declarations, gate calls with parameter expressions (``+ - * / ^``, unary
signs, ``pi``, ``sin cos tan exp ln sqrt``), the ``U`` and ``CX``
primitives, ``barrier`` and ``//`` comments. ``measure``, ``reset`` and
``if`` are parsed so that the importer can reject them by name.

The parser needs nothing beyond the standard library. Keywords are
contextual, as in the reference's grammar: a statement starts with a
keyword only where a statement may start (``OPENQASM`` only as the first
word, ``barrier`` also inside a gate body), so a register or parameter may
be called ``gate`` or ``pi``; inside an expression ``pi`` is reserved, and a
function name is a call where ``(`` follows it and a parameter elsewhere.
The reference's parser accepts no function call at all (its lexer reads
``sin`` as a name there); every program it accepts parses here to the same
statements. Operator precedence and associativity are the
grammar's: ``+ -`` and ``* /`` associate to the left, a unary sign binds
tighter than ``* /`` and looser than ``^``, and ``^`` takes a signed
factor on its right (``2^-1``, ``2^3^2`` = ``2^9``).

>>> stmts = parse('OPENQASM 2.0; qreg q[2]; CX q[0], q[1];')
>>> [type(s).__name__ for s in stmts]
['Register', 'GateCall']
>>> stmts[1]
GateCall(name='CX', exprs=(), args=(Argument(name='q', index=0), Argument(name='q', index=1)))
>>> parse('U(-pi/2, 2^-1, sqrt(2)) q[0];')[0].exprs
(('div', ('neg', ('pi',)), ('number', '2')), ('pow', ('number', '2'), ('neg', ('number', '1'))), ('func', 'sqrt', ('number', '2')))
"""

from __future__ import annotations

import re
from dataclasses import dataclass

QASM2_GRAMMAR = r"""
start        := version? statement*
version      := "OPENQASM" REAL ";"                 (first word only)
statement    := include | qreg | creg | gate_decl | opaque_decl
              | gate_call | barrier | measure | reset | if
include      := "include" STRING ";"
qreg         := "qreg" NAME "[" INT "]" ";"
creg         := "creg" NAME "[" INT "]" ";"
gate_decl    := "gate" NAME params? id_list "{" (gate_call | barrier)* "}"
opaque_decl  := "opaque" NAME params? id_list ";"
params       := "(" [NAME ("," NAME)*] ")"
id_list      := NAME ("," NAME)*
gate_call    := NAME call_args? argument ("," argument)* ";"   (NAME includes U, CX)
call_args    := "(" [expr ("," expr)*] ")"
argument     := NAME ("[" INT "]")?
barrier      := "barrier" argument ("," argument)* ";"
measure      := "measure" argument "->" argument ";"
reset        := "reset" argument ";"
if           := "if" "(" NAME "==" INT ")" gate_call
expr         := term (("+" | "-") term)*
term         := factor (("*" | "/") factor)*
factor       := "-" factor | "+" factor | power
power        := atom ("^" factor)?
atom         := REAL | "pi" | FUNC "(" expr ")" | NAME | "(" expr ")"
                (a FUNC word not followed by "(" is a NAME)
FUNC         := "sin" | "cos" | "tan" | "exp" | "ln" | "sqrt"
REAL         := \d+\.\d*([eE][+-]?\d+)? | \.\d+([eE][+-]?\d+)? | \d+([eE][+-]?\d+)?
INT          := \d+
NAME         := [A-Za-z_][A-Za-z0-9_]*
comments     := //[^\n]*  (skipped, as is whitespace [ \t\f\r\n]+)
"""

FUNCS = ("sin", "cos", "tan", "exp", "ln", "sqrt")

#: words that start a statement where a statement may start
_STATEMENT_KEYWORDS = frozenset(
    ("include", "qreg", "creg", "gate", "opaque", "barrier", "measure", "reset", "if")
)

_TOKEN = re.compile(
    r"""
    (?P<ws>[ \t\f\r\n]+)
  | (?P<comment>//[^\n]*)
  | (?P<number>\d+\.\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?|\d+(?:[eE][+-]?\d+)?)
  | (?P<word>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<string>"(?:[^"\\\n]|\\.)*")
  | (?P<op>->|==|[;,()\[\]{}+\-*/^])
    """,
    re.VERBOSE,
)
_INT = re.compile(r"\d+")


class QasmSyntaxError(ValueError):
    """The source is not in the grammar (the importer wraps it)."""


@dataclass(frozen=True)
class Token:
    kind: str  # "number", "word", "string", "op" or "end"
    text: str
    line: int
    column: int


@dataclass(frozen=True)
class Argument:
    """``name`` or ``name[index]``."""

    name: str
    index: int | None


@dataclass(frozen=True)
class GateCall:
    """``name(exprs) args;``; an expression is a tuple tree: ``("number",
    text)``, ``("pi",)``, ``("name", name)``, ``("func", name, arg)``,
    ``("neg", arg)`` or ``(op, left, right)`` with op one of ``add sub mul
    div pow``."""

    name: str
    exprs: tuple
    args: tuple[Argument, ...]


@dataclass(frozen=True)
class Register:
    kind: str  # "qreg" or "creg"
    name: str
    size: int


@dataclass(frozen=True)
class GateDecl:
    """A ``gate`` definition; ``body`` keeps its gate calls (a ``barrier``
    in a body is parsed and dropped)."""

    name: str
    params: tuple[str, ...]
    qubits: tuple[str, ...]
    body: tuple[GateCall, ...]


@dataclass(frozen=True)
class Opaque:
    name: str


@dataclass(frozen=True)
class Keyword:
    """A parsed statement the importer handles by its keyword alone:
    ``include``, ``barrier``, ``measure``, ``reset`` or ``if``."""

    keyword: str


def tokenize(code: str) -> list[Token]:
    """The tokens of ``code``, comments and whitespace dropped, closed by
    an ``end`` token.

    >>> [t.text for t in tokenize("rx(-0.5e1) q[0]; // done")]
    ['rx', '(', '-', '0.5e1', ')', 'q', '[', '0', ']', ';', '']
    """
    tokens = []
    pos, line, line_start = 0, 1, 0
    while pos < len(code):
        m = _TOKEN.match(code, pos)
        if m is None:
            raise QasmSyntaxError(
                f"line {line}, column {pos - line_start + 1}: "
                f"unexpected character {code[pos]!r}"
            )
        kind = m.lastgroup
        if kind not in ("ws", "comment"):
            tokens.append(Token(kind, m.group(), line, pos - line_start + 1))
        newlines = m.group().count("\n")
        if newlines:
            line += newlines
            line_start = m.start() + m.group().rindex("\n") + 1
        pos = m.end()
    tokens.append(Token("end", "", line, pos - line_start + 1))
    return tokens


class _Parser:
    def __init__(self, code: str) -> None:
        self.tokens = tokenize(code)
        self.pos = 0

    # -- token helpers -----------------------------------------------------

    def peek(self) -> Token:
        return self.tokens[self.pos]

    def next(self) -> Token:
        tok = self.tokens[self.pos]
        if tok.kind != "end":
            self.pos += 1
        return tok

    def error(self, tok: Token, wanted: str):
        got = "end of input" if tok.kind == "end" else repr(tok.text)
        return QasmSyntaxError(f"line {tok.line}, column {tok.column}: expected {wanted}, got {got}")

    def at(self, text: str) -> bool:
        tok = self.peek()
        return tok.kind in ("op", "word") and tok.text == text

    def expect(self, text: str) -> Token:
        tok = self.next()
        if tok.kind not in ("op", "word") or tok.text != text:
            raise self.error(tok, repr(text))
        return tok

    def name(self) -> str:
        tok = self.next()
        if tok.kind != "word":
            raise self.error(tok, "a name")
        return tok.text

    def integer(self) -> int:
        tok = self.next()
        if tok.kind != "number" or not _INT.fullmatch(tok.text):
            raise self.error(tok, "an integer")
        return int(tok.text)

    def names(self) -> tuple[str, ...]:
        out = [self.name()]
        while self.at(","):
            self.next()
            out.append(self.name())
        return tuple(out)

    # -- statements --------------------------------------------------------

    def program(self) -> list:
        stmts = []
        if self.at("OPENQASM"):
            self.next()
            tok = self.next()
            if tok.kind != "number":
                raise self.error(tok, "a version number")
            self.expect(";")
        while self.peek().kind != "end":
            stmts.append(self.statement())
        return stmts

    def statement(self):
        tok = self.peek()
        if tok.kind != "word":
            raise self.error(tok, "a statement")
        word = tok.text
        if word not in _STATEMENT_KEYWORDS:
            return self.gate_call()
        self.next()
        if word == "include":
            tok = self.next()
            if tok.kind != "string":
                raise self.error(tok, "a quoted file name")
            self.expect(";")
            return Keyword("include")
        if word in ("qreg", "creg"):
            name = self.name()
            self.expect("[")
            size = self.integer()
            self.expect("]")
            self.expect(";")
            return Register(word, name, size)
        if word == "gate":
            return self.gate_decl()
        if word == "opaque":
            name = self.name()
            self.params()
            self.names()
            self.expect(";")
            return Opaque(name)
        if word == "barrier":
            self.arguments()
            self.expect(";")
            return Keyword("barrier")
        if word == "measure":
            self.argument()
            self.expect("->")
            self.argument()
            self.expect(";")
            return Keyword("measure")
        if word == "reset":
            self.argument()
            self.expect(";")
            return Keyword("reset")
        # if
        self.expect("(")
        self.name()
        self.expect("==")
        self.integer()
        self.expect(")")
        self.gate_call()
        return Keyword("if")

    def params(self) -> tuple[str, ...]:
        if not self.at("("):
            return ()
        self.next()
        params = () if self.at(")") else self.names()
        self.expect(")")
        return params

    def gate_decl(self) -> GateDecl:
        name = self.name()
        params = self.params()
        qubits = self.names()
        self.expect("{")
        body = []
        while not self.at("}"):
            if self.at("barrier"):
                self.next()
                self.arguments()
                self.expect(";")
            else:
                body.append(self.gate_call())
        self.next()
        return GateDecl(name, params, qubits, tuple(body))

    def gate_call(self) -> GateCall:
        name = self.name()
        exprs: list = []
        if self.at("("):
            self.next()
            if not self.at(")"):
                exprs.append(self.expr())
                while self.at(","):
                    self.next()
                    exprs.append(self.expr())
            self.expect(")")
        args = self.arguments()
        self.expect(";")
        return GateCall(name, tuple(exprs), args)

    def argument(self) -> Argument:
        name = self.name()
        index = None
        if self.at("["):
            self.next()
            index = self.integer()
            self.expect("]")
        return Argument(name, index)

    def arguments(self) -> tuple[Argument, ...]:
        out = [self.argument()]
        while self.at(","):
            self.next()
            out.append(self.argument())
        return tuple(out)

    # -- expressions -------------------------------------------------------

    def expr(self):
        left = self.term()
        while self.at("+") or self.at("-"):
            op = "add" if self.next().text == "+" else "sub"
            left = (op, left, self.term())
        return left

    def term(self):
        left = self.factor()
        while self.at("*") or self.at("/"):
            op = "mul" if self.next().text == "*" else "div"
            left = (op, left, self.factor())
        return left

    def factor(self):
        if self.at("-"):
            self.next()
            return ("neg", self.factor())
        if self.at("+"):
            self.next()
            return self.factor()
        base = self.atom()
        if self.at("^"):
            self.next()
            return ("pow", base, self.factor())
        return base

    def atom(self):
        tok = self.next()
        if tok.kind == "number":
            return ("number", tok.text)
        if tok.kind == "word":
            if tok.text == "pi":
                return ("pi",)
            if tok.text in FUNCS and self.at("("):
                self.next()
                arg = self.expr()
                self.expect(")")
                return ("func", tok.text, arg)
            return ("name", tok.text)
        if tok.kind == "op" and tok.text == "(":
            inner = self.expr()
            self.expect(")")
            return inner
        raise self.error(tok, "an expression")


def parse(code: str) -> list:
    """The statements of an OpenQASM 2.0 program (the version header
    checked and dropped), in source order; raises :class:`QasmSyntaxError`
    where the source leaves the grammar."""
    return _Parser(code).program()
