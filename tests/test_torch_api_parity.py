"""The port's public surface against the reference's.

Every module of ``tnc_tpu`` that has a counterpart under the same path in
``tnc_tpu_torch`` is read by AST on both sides: the port must define each
public top-level name, each public method of each public class and each
parameter of each public function and method the reference defines. Each
package ``__init__`` of the port must resolve every name the reference's
exports, and every entry of the reference's ``tests/test_api_surface.py``
``SURFACE`` must resolve in the port with ``tnc_tpu`` renamed.

The only exceptions are the items tied to JAX, XLA or lark in
:data:`EXCEPTIONS`; each names the text of its ROADMAP Divergences entry,
and a second case fails on an exception the port no longer needs.
"""

import ast
import importlib
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
REF = REPO / "tnc_tpu"
PORT = REPO / "tnc_tpu_torch"

# the reference's kernels, ported as CUDA sources (csrc/*.cu), not a module
NO_PORT_MODULE = {"ops/pallas_complex.py": "`fused_chain_kl`"}

# (module, item) -> the text that names it in ROADMAP's Divergences. An item
# is a top-level name (its methods go with it), "Class.method", or
# "function(parameter)".
EXCEPTIONS = {
    ("ops/backends.py", "JaxBackend"): "`JaxBackend`",
    ("ops/backends.py", "jit_program"): "`jit_program`",
    ("ops/backends.py", "lanemix_env"): "`lanemix_env`",
    ("ops/sliced.py", "make_jax_sliced_fn"): "`make_jax_sliced_fn`",
    ("ops/chunked.py", "execute_sliced_batched_jax"): "`execute_sliced_batched_jax`",
    ("ops/budget.py", "compiled_peak_bytes"): "`compiled_peak_bytes`",
    ("ops/batched.py", "apply_step_batched"): "`apply_step_batched`",
    ("io/qasm/grammar.py", "parse_example"): "`parse_example`",
    ("ops/backends.py", "apply_step(xp)"): "`xp`",
    ("ops/backends.py", "run_steps_timed(xp)"): "`xp`",
    ("ops/batched.py", "run_steps_batched(xp)"): "`xp`",
    ("ops/hoist.py", "run_prelude(xp)"): "`xp`",
    ("ops/hoist.py", "run_prelude_steps(xp)"): "`xp`",
    ("ops/sliced.py", "index_buffer(xp)"): "`xp`",
    ("ops/split_complex.py", "apply_step_split(xp)"): "`xp`",
    ("ops/split_complex.py", "gauss_matmul(xp)"): "`xp`",
    ("ops/split_complex.py", "run_chain_split(xp)"): "`xp`",
    ("ops/split_complex.py", "run_steps_split(xp)"): "`xp`",
    ("ops/strassen.py", "gauss_strassen_dot_kl(xp)"): "`xp`",
    ("ops/strassen.py", "strassen_dot_kl(xp)"): "`xp`",
    ("parallel/sliced_parallel.py", "distributed_sliced_contraction(unroll)"): "`unroll`",
}


def _params(fn) -> list[str]:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    if a.vararg:
        names.append("*" + a.vararg.arg)
    if a.kwarg:
        names.append("**" + a.kwarg.arg)
    return [n for n in names if n not in ("self", "cls")]


def _surface(path: Path, imported: bool = False):
    """``(names, methods, params)`` of a module: the public names it defines
    (and, with ``imported``, the ones it imports), each public class's
    public methods, each public function's and method's parameters (keys
    ``"f"`` and ``"Class.method"``, ``__init__`` included)."""
    names, methods, params = set(), {}, {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if not node.name.startswith("_"):
                names.add(node.name)
                params[node.name] = _params(node)
        elif isinstance(node, ast.ClassDef):
            if node.name.startswith("_"):
                continue
            names.add(node.name)
            methods[node.name] = set()
            for sub in node.body:
                if not isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                if sub.name == "__init__" or not sub.name.startswith("_"):
                    if sub.name != "__init__":
                        methods[node.name].add(sub.name)
                    params[f"{node.name}.{sub.name}"] = _params(sub)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets
                      if isinstance(t, ast.Name) and not t.id.startswith("_")}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            if not node.target.id.startswith("_"):
                names.add(node.target.id)
        elif imported and isinstance(node, ast.ImportFrom):
            names |= {a.asname or a.name for a in node.names}
    return names, methods, params


def _missing(rel: str) -> list[str]:
    """The reference items of module ``rel`` the port lacks, as
    :data:`EXCEPTIONS` names them."""
    names, methods, params = _surface(REF / rel)
    pnames, pmethods, pparams = _surface(PORT / rel, imported=True)
    out = [n for n in sorted(names) if n not in pnames]
    for cls in sorted(methods):
        if cls in out:
            continue
        out += [f"{cls}.{m}" for m in sorted(methods[cls] - pmethods.get(cls, set()))]
    for fn in sorted(params):
        if fn.split(".")[0] in out or fn in out:
            continue
        if fn not in pparams:
            out.append(fn)  # an __init__ the port does not define
            continue
        out += [f"{fn}({p.lstrip('*')})" for p in params[fn] if p not in pparams[fn]]
    return out


REF_MODULES = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))
PORTED = [rel for rel in REF_MODULES if rel not in NO_PORT_MODULE]


def _divergences() -> str:
    text = (REPO / "ROADMAP.md").read_text()
    start = text.index("\n## Divergences")
    return text[start:text.index("\n## ", start + 1)]


def test_every_reference_module_has_a_port_module():
    missing = [rel for rel in PORTED if not (PORT / rel).exists()]
    assert not missing, f"no port module for {missing}"
    for rel, text in NO_PORT_MODULE.items():
        assert not (PORT / rel).exists()
        assert text in (REPO / "ROADMAP.md").read_text()


@pytest.mark.parametrize("rel", PORTED)
def test_port_module_has_the_reference_surface(rel):
    missing = [item for item in _missing(rel) if (rel, item) not in EXCEPTIONS]
    assert not missing, f"tnc_tpu_torch/{rel} lacks {missing}"


@pytest.mark.parametrize("key", sorted(EXCEPTIONS), ids=lambda k: f"{k[0]}::{k[1]}")
def test_exception_is_still_missing_and_recorded(key):
    """An exception names an item the port still lacks (else it is stale:
    take it out of the table) and its ROADMAP Divergences entry."""
    rel, item = key
    assert item in _missing(rel), f"stale exception: tnc_tpu_torch/{rel} has {item}"
    assert EXCEPTIONS[key] in _divergences(), f"no Divergences entry names {EXCEPTIONS[key]}"


def _exports(init: Path) -> set[str]:
    """The names a reference ``__init__`` exports: what it imports or
    defines, and the keys of its lazy-export tables."""
    out = set()
    for node in ast.parse(init.read_text()).body:
        if isinstance(node, ast.ImportFrom):
            out |= {a.asname or a.name for a in node.names}
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and not t.id.startswith("_"):
                    out.add(t.id)
                elif isinstance(t, ast.Name) and isinstance(node.value, ast.Dict):
                    out |= {k.value for k in node.value.keys
                            if isinstance(k, ast.Constant) and isinstance(k.value, str)}
    return {n for n in out if not n.startswith("_")}


INITS = sorted(str(p.parent.relative_to(REF)) for p in REF.rglob("__init__.py"))


def _package(rel: str) -> str:
    return "tnc_tpu_torch" + ("" if rel == "." else "." + rel.replace("/", "."))


@pytest.mark.parametrize("rel", INITS)
def test_package_exports_the_reference_names(rel):
    names = _exports(REF / rel / "__init__.py")
    if rel == "ops":
        names.discard("JaxBackend")  # EXCEPTIONS: ops/backends.py JaxBackend
    package = importlib.import_module(_package(rel))
    missing = sorted(n for n in names if not hasattr(package, n))
    assert not missing, f"{_package(rel)} does not export {missing}"


def _reference_surface() -> dict:
    tree = ast.parse((REPO / "tests" / "test_api_surface.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "SURFACE" for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError("tests/test_api_surface.py has no SURFACE")


SURFACE = _reference_surface()


@pytest.mark.parametrize("module", sorted(SURFACE))
def test_reference_surface_entry_resolves_in_the_port(module):
    port = importlib.import_module(module.replace("tnc_tpu", "tnc_tpu_torch", 1))
    missing = [name for name in SURFACE[module] if not hasattr(port, name)]
    assert not missing, f"{port.__name__} lacks {missing}"


def test_ops_package_loads_without_torch():
    """The lazy exports keep torch out of a process that imports only the
    program compiler or the annealer (their spawn workers)."""
    import subprocess
    import sys

    code = ("import sys, tnc_tpu_torch.ops.program, "
            "tnc_tpu_torch.contractionpath.repartitioning.simulated_annealing, "
            "tnc_tpu_torch.builders, tnc_tpu_torch.tensornetwork, tnc_tpu_torch.contractionpath; "
            "assert 'torch' not in sys.modules and 'jax' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True)


def test_builder_functions_win_over_their_modules():
    """``peps``, ``random_circuit`` and ``sycamore_circuit`` name both a
    module and the function it defines: the package attribute is the
    function, as in the reference, whichever was imported first."""
    import tnc_tpu_torch.builders.peps  # noqa: F401
    from tnc_tpu_torch import builders

    for name in ("peps", "random_circuit", "sycamore_circuit"):
        assert callable(getattr(builders, name)), name
