"""The port's batched execution (``tnc_tpu_torch.ops.batched`` and
``execute_batched`` on both backends) against the JAX package on the CPU.

- ``thread_batch`` gives the reference's flags and ``feasible``.
- ``NumpyBackend.execute_batched`` is bitwise equal to the reference's,
  threaded and (on a program whose batched operand meets a staged prep
  plan) through the per-row loop.
- ``TorchBackend(device="cpu", split_complex=True/False).execute_batched``
  is within 1e-5 of max|ref| of the reference's ``JaxBackend(
  split_complex=True).execute_batched`` (Pallas in interpret mode) and of
  the port's sequential ``execute``, under the default ladder and the
  forced ``fused`` rung.
- The no-model ladder plans the reference's chains on the sweep programs;
  a chain whose head is unbatched and whose later link reads a bra gives,
  batched, each row's unbatched chain.

Configurations: ``sycamore_circuit(12, 4)`` and ``(16, 6)`` (rng 42) and a
10-qubit random circuit on a line, swept over 6 bitstrings.
"""

import dataclasses
import doctest
import functools

import numpy as np
import pytest
import torch

import tnc_tpu_torch.ops.batched as port_batched
from tnc_tpu.builders.connectivity import ConnectivityLayout as RefLayout
from tnc_tpu.builders.random_circuit import random_open_circuit as ref_random
from tnc_tpu.builders.sycamore_circuit import sycamore_circuit as ref_sycamore
from tnc_tpu.ops.backends import JaxBackend
from tnc_tpu.ops.backends import NumpyBackend as RefNumpyBackend
from tnc_tpu.ops.batched import thread_batch as ref_thread_batch
from tnc_tpu.ops.split_complex import plan_kernels as ref_plan_kernels
from tnc_tpu.tensornetwork.sweep import _sweep_program as ref_sweep_program
from tnc_tpu_torch.builders.connectivity import ConnectivityLayout
from tnc_tpu_torch.builders.random_circuit import random_open_circuit
from tnc_tpu_torch.builders.sycamore_circuit import sycamore_circuit
from tnc_tpu_torch.ops import split_complex
from tnc_tpu_torch.ops.backends import NumpyBackend, TorchBackend
from tnc_tpu_torch.ops.batched import run_steps_batched, stacked_rows, thread_batch
from tnc_tpu_torch.tensornetwork.sweep import _sweep_program

CASES = ["syc12m4", "syc16m6", "rand10"]
BATCH = 6
REL = 1e-5


def _circuit(case, port: bool):
    if case == "rand10":
        build, layout = (random_open_circuit, ConnectivityLayout) if port else (
            ref_random, RefLayout)
        return build(10, 6, 0.5, 0.5, np.random.default_rng(3), layout.LINE)
    q, m = {"syc12m4": (12, 4), "syc16m6": (16, 6)}[case]
    build = sycamore_circuit if port else ref_sycamore
    return build(q, m, np.random.default_rng(42))


def _bits(n):
    rows = np.random.default_rng(7).integers(0, 2, (BATCH - 1, n))
    return ["0" * n] + ["".join(str(int(b)) for b in r) for r in rows]


@functools.lru_cache(maxsize=None)
def _programs(case):
    """(port program, arrays, bra slots), the same of the reference."""
    n = _circuit(case, True).num_qubits()
    port = _sweep_program(_circuit(case, True), _bits(n), None)
    ref = ref_sweep_program(_circuit(case, False), _bits(n), None)
    return port, ref


@functools.lru_cache(maxsize=None)
def _jax_batched(case, rung):
    _, (program, arrays, bras) = _programs(case)
    with _rung(rung):
        return np.asarray(JaxBackend(split_complex=True).execute_batched(program, arrays, bras))


class _rung:
    """``TNC_TPU_COMPLEX_MULT`` set to ``rung`` (``None``: unset) inside."""

    def __init__(self, rung):
        self.rung = rung

    def __enter__(self):
        self.mp = pytest.MonkeyPatch()
        if self.rung is None:
            self.mp.delenv("TNC_TPU_COMPLEX_MULT", raising=False)
        else:
            self.mp.setenv("TNC_TPU_COMPLEX_MULT", self.rung)

    def __exit__(self, *exc):
        self.mp.undo()


def test_doctests():
    assert doctest.testmod(port_batched).failed == 0


@pytest.mark.parametrize("case", CASES)
def test_programs_match_reference(case):
    (program, _, bras), (ref_program, _, ref_bras) = _programs(case)
    assert bras == ref_bras
    assert program.signature_digest() == ref_program.signature_digest()


@pytest.mark.parametrize("case", CASES)
def test_thread_batch_matches_reference(case):
    (program, _, bras), (ref_program, _, ref_bras) = _programs(case)
    rng = np.random.default_rng(1)
    slot_sets = [bras, [0], list(range(program.num_inputs)),
                 sorted(rng.choice(program.num_inputs, 5, replace=False).tolist())]
    for slots in slot_sets:
        assert thread_batch(program, slots) == ref_thread_batch(ref_program, slots)
    # a staged prep plan on a batched operand makes the threading infeasible
    i, st = next((i, st) for i, st in enumerate(program.steps) if st.lhs in bras or st.rhs in bras)
    side = "a_ops" if st.lhs in bras else "b_ops"
    staged = dataclasses.replace(program, steps=program.steps[:i] + (
        dataclasses.replace(st, **{side: (("reshape", (-1,)),)}),) + program.steps[i + 1:])
    ref_st = ref_program.steps[i]
    ref_staged = dataclasses.replace(ref_program, steps=ref_program.steps[:i] + (
        dataclasses.replace(ref_st, **{side: (("reshape", (-1,)),)}),) + ref_program.steps[i + 1:])
    flags, feasible = thread_batch(staged, bras)
    assert not feasible
    assert (flags, feasible) == ref_thread_batch(ref_staged, bras)


@pytest.mark.parametrize("case", CASES)
def test_numpy_execute_batched_is_the_references_bits(case):
    (program, arrays, bras), (ref_program, ref_arrays, ref_bras) = _programs(case)
    got = NumpyBackend().execute_batched(program, arrays, bras)
    want = RefNumpyBackend().execute_batched(ref_program, ref_arrays, ref_bras)
    assert got.shape == (BATCH,) + tuple(program.result_shape)
    assert np.array_equal(got, want)
    # each row bit-compares to its own sequential run
    for i in range(BATCH):
        per = [a[i] if s in bras else a for s, a in enumerate(arrays)]
        assert np.array_equal(got[i], NumpyBackend().execute(program, per))


def test_numpy_execute_batched_falls_back_to_rows_when_infeasible():
    (program, arrays, bras), (ref_program, ref_arrays, _) = _programs("syc12m4")
    i, st = next((i, st) for i, st in enumerate(program.steps) if st.rhs in bras)
    ops = (("reshape", (-1,)),)
    staged = dataclasses.replace(program, steps=program.steps[:i] + (
        dataclasses.replace(st, b_ops=ops),) + program.steps[i + 1:])
    ref_staged = dataclasses.replace(ref_program, steps=ref_program.steps[:i] + (
        dataclasses.replace(ref_program.steps[i], b_ops=ops),) + ref_program.steps[i + 1:])
    assert not thread_batch(staged, bras)[1]
    got = NumpyBackend().execute_batched(staged, arrays, bras)
    assert np.array_equal(got, RefNumpyBackend().execute_batched(ref_staged, ref_arrays, bras))
    assert np.array_equal(got, NumpyBackend().execute_batched(program, arrays, bras))


def test_execute_batched_needs_a_batched_slot():
    (program, arrays, _), _ = _programs("syc12m4")
    for backend in (NumpyBackend(), TorchBackend(device="cpu")):
        with pytest.raises(ValueError, match="at least one batched slot"):
            backend.execute_batched(program, arrays, [])


def test_stacked_rows_stacks_each_rows_run():
    (program, arrays, bras), _ = _programs("syc12m4")
    got = stacked_rows(lambda per: NumpyBackend().execute(program, per), arrays, bras,
                       BATCH, program.result_shape)
    assert np.array_equal(got, NumpyBackend().execute_batched(program, arrays, bras))


@pytest.mark.parametrize("rung", [None, "fused"], ids=["default", "fused"])
@pytest.mark.parametrize("split", [True, False], ids=["split", "native"])
@pytest.mark.parametrize("case", CASES)
def test_torch_execute_batched_matches_reference(case, split, rung):
    (program, arrays, bras), _ = _programs(case)
    want = _jax_batched(case, rung)
    scale = float(np.max(np.abs(want)))
    backend = TorchBackend(device="cpu", split_complex=split)
    with _rung(rung):
        got = backend.execute_batched(program, arrays, bras)
        seq = np.stack([
            backend.execute(program, [a[i] if s in bras else a for s, a in enumerate(arrays)])
            for i in range(BATCH)])
    assert got.shape == want.shape == (BATCH,) + tuple(program.result_shape)
    assert float(np.max(np.abs(got - want))) <= REL * scale
    assert float(np.max(np.abs(got - seq))) <= REL * scale


@pytest.mark.parametrize("case", CASES)
def test_torch_execute_batched_complex128_matches_numpy(case):
    (program, arrays, bras), _ = _programs(case)
    want = NumpyBackend().execute_batched(program, arrays, bras)
    scale = float(np.max(np.abs(want)))
    for split in (True, False):
        got = TorchBackend(dtype="complex128", device="cpu", split_complex=split).execute_batched(
            program, arrays, bras)
        assert float(np.max(np.abs(got - want))) <= 1e-12 * scale


@pytest.mark.parametrize("case", CASES)
def test_policy_chains_match_reference(case):
    (program, _, bras), (ref_program, _, _) = _programs(case)
    with _rung(None):
        policy = split_complex.plan_kernels(program)
        ref_policy = ref_plan_kernels(ref_program)
    assert policy.chains == ref_policy.chains
    assert policy.modes == ref_policy.modes
    assert policy.chains, "the sweep program forms no chain"


def _chain_touching_late_bra(program, bras, policy):
    """A chain whose head reads no batched slot and a later link does."""
    flags, _ = thread_batch(program, bras)
    for s, e in policy.chains:
        if flags[s] == (False, False) and any(any(f) for f in flags[s + 1:e]):
            return s, e
    return None


@pytest.mark.parametrize("case", ["syc16m6", "rand10"])
def test_batched_chain_with_late_bra_equals_rows(case):
    """The batched plain chain, run by ``run_chain_split`` on the buffers
    the batched executor holds at the chain, equals each row's unbatched
    chain; the set of batched slots gains the chain's result slot."""
    (program, arrays, bras), _ = _programs(case)
    policy = split_complex.plan_kernels(program)
    found = _chain_touching_late_bra(program, bras, policy)
    assert found is not None, f"{case}: no chain brings a bra in after its head"
    s, e = found
    backend = TorchBackend(device="cpu", split_complex=True)
    buffers = backend._device_buffers(arrays)
    batched = set(bras)
    split_complex.run_split_units(program.steps[:s], buffers, policy=split_complex.KernelPolicy(
        policy.modes[:s]), batched=batched)
    rows = [[(p[0][i], p[1][i]) if (p is not None and k in batched) else p
             for k, p in enumerate(buffers)] for i in range(BATCH)]
    steps = program.steps[s:e]
    got = split_complex.run_chain_split(steps, list(buffers), batched)
    assert steps[-1].lhs in batched
    for i in range(BATCH):
        want = split_complex.run_chain_split(steps, rows[i], set())
        for g, w in zip(got, want):
            assert torch.equal(g[i], w)


def test_torch_run_steps_batched_matches_numpy():
    """The native runner on complex128 torch tensors against the numpy
    batched run."""
    (program, arrays, bras), _ = _programs("syc12m4")
    flags, _ = thread_batch(program, bras)
    buffers = [torch.from_numpy(np.asarray(a)) for a in arrays]
    out = run_steps_batched(program, list(buffers), flags)
    want = NumpyBackend().execute_batched(program, arrays, bras)
    assert out.shape[0] == BATCH
    assert np.max(np.abs(out.numpy().reshape(want.shape) - want)) <= 1e-12 * np.max(np.abs(want))
