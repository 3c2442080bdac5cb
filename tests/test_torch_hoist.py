"""The port's hoist pass (``tnc_tpu_torch.ops.hoist``) and per-step
promotion (``split_complex.auto_step_mode``) against the JAX package's, on
the CPU.

- ``hoist_sliced_program`` gives the reference's prelude (slots, steps,
  inputs), residual sources and residual program, on the two small Sycamore
  amplitudes and on the 53-qubit depth-10 cell (128 prelude steps, 41
  residual steps); ``hoist_split_counts`` and ``hoist_step_flops`` match.
- ``auto_step_mode`` picks the reference's mode on every step of those
  plans and of the ``peps(4, 4, 2, 32, 0)`` norm, unforced and under each
  ``TNC_TPU_COMPLEX_MULT`` override.
- The prelude run on torch (split float32 and float64 parts, native
  complex) gives the reference's numpy prelude within 1e-5 (float32) and
  1e-12 (float64) of max|ref|, and the hoisted complex128 oracle equals
  the unhoisted one.
"""

import doctest

import numpy as np
import pytest
import torch

import tnc_tpu.ops.hoist as ref_hoist
import tnc_tpu.ops.split_complex as ref_sc
import tnc_tpu_torch.ops.hoist as port_hoist
import tnc_tpu_torch.ops.split_complex as port_sc
from tnc_tpu.builders.peps import peps as ref_peps
from tnc_tpu.contractionpath.paths import Greedy as RefGreedy
from tnc_tpu.contractionpath.paths import OptMethod as RefOptMethod
from tnc_tpu.ops.program import build_program as ref_build_program
from tnc_tpu_torch.builders.peps import peps as port_peps
from tnc_tpu_torch.contractionpath.paths import Greedy, OptMethod
from tnc_tpu_torch.ops.backends import NumpyBackend, place_buffers
from tnc_tpu_torch.ops.program import build_program
from tests._torch_sliced_cases import CELL, SIXTEEN, SMALL, WIDE, _both, _ids, _scalar

PLANNED = [SMALL, SIXTEEN, CELL]
STEP_FIELDS = ("lhs", "rhs", "a_view", "a_perm", "a_dot", "a_cfirst", "b_view",
               "b_perm", "b_dot", "b_cfirst", "swap", "out_store")
FORCED = [None, "auto", "naive", "gauss", "fused", "fused_transpose", "strassen", "chain"]


def _same_step(a, b) -> bool:
    return all(getattr(a, f) == getattr(b, f) for f in STEP_FIELDS)


def _hoisted(cfg):
    both = _both(cfg)
    return (port_hoist.hoist_sliced_program(both["port"]["sp"]),
            ref_hoist.hoist_sliced_program(both["ref"]["sp"]))


@pytest.mark.parametrize("cfg", PLANNED, ids=_ids(PLANNED))
def test_hoist_split_matches_reference(cfg):
    port, ref = _hoisted(cfg)
    assert not port.is_noop
    assert port.prelude_num_slots == ref.prelude_num_slots
    assert port.prelude_inputs == ref.prelude_inputs
    assert port.residual_sources == ref.residual_sources
    for p, r in zip(port.prelude_steps, ref.prelude_steps, strict=True):
        assert (p.out, p.lhs, p.rhs, p.free_rhs) == (r.out, r.lhs, r.rhs, r.free_rhs)
        assert _same_step(p.step, r.step)
    res, ref_res = port.residual, ref.residual
    assert res.slot_slices == ref_res.slot_slices
    assert res.slicing.legs == ref_res.slicing.legs
    for p, r in zip(res.program.steps, ref_res.program.steps, strict=True):
        assert _same_step(p, r)
    assert (res.program.num_inputs, res.program.result_slot) == (
        ref_res.program.num_inputs, ref_res.program.result_slot)
    both = _both(cfg)
    assert port_hoist.hoist_split_counts(both["port"]["sp"]) == ref_hoist.hoist_split_counts(
        both["ref"]["sp"])
    assert port_hoist.hoist_step_flops(both["port"]["sp"]) == ref_hoist.hoist_step_flops(
        both["ref"]["sp"])


def test_cell_hoists_128_prelude_steps_and_leaves_41():
    """The 53-qubit cell: 128 steps run once (1.37e8 multiply-adds), 41 per
    slice over 42 inputs — 13 sliced leaves and 17 cached intermediates."""
    port, _ = _hoisted(CELL)
    counts = port_hoist.hoist_split_counts(_both(CELL)["port"]["sp"])
    assert (counts["prelude_steps"], counts["residual_steps"]) == (128, 41)
    assert 1.3e8 < counts["invariant_flops"] < 1.4e8
    assert port.residual.program.num_inputs == 42
    kinds = [kind for kind, _ in port.residual_sources]
    assert kinds.count("cached") == 17
    assert sum(bool(info) for info in port.residual.slot_slices) == 13


def test_unsliced_program_hoists_nothing():
    port = _both(SMALL)["port"]
    from tnc_tpu_torch.contractionpath.slicing import Slicing
    from tnc_tpu_torch.ops.sliced import build_sliced_program

    sp = build_sliced_program(port["tn"], port["path"], Slicing((), ()))
    hp = port_hoist.hoist_sliced_program(sp)
    assert hp.is_noop and hp.residual is sp
    assert hp.residual_sources == tuple(("leaf", s) for s in range(sp.program.num_inputs))


def test_module_doctests():
    result = doctest.testmod(port_hoist)
    assert result.failed == 0 and result.attempted >= 3


def _peps_steps():
    args = (4, 4, 2, 32, 0)
    ref_tn, port_tn = ref_peps(*args), port_peps(*args)
    ref_path = RefGreedy(RefOptMethod.GREEDY).find_path(ref_tn).replace_path()
    port_path = Greedy(OptMethod.GREEDY).find_path(port_tn).replace_path()
    return (build_program(port_tn, port_path).steps,
            ref_build_program(ref_tn, ref_path).steps)


@pytest.mark.parametrize("force", FORCED, ids=[str(f) for f in FORCED])
def test_auto_step_mode_matches_reference(force, monkeypatch):
    """Every step of the three sliced programs (their preludes among them)
    and of the PEPS norm: the port promotes the steps the reference promotes
    (Strassen over the crossover) and defers to a forced mode where the
    reference does."""
    if force is None:
        monkeypatch.delenv("TNC_TPU_COMPLEX_MULT", raising=False)
    else:
        monkeypatch.setenv("TNC_TPU_COMPLEX_MULT", force)
    pairs = [_peps_steps()]
    for cfg in PLANNED:
        both = _both(cfg)
        pairs.append((both["port"]["sp"].program.steps, both["ref"]["sp"].program.steps))
    promoted = 0
    for port_steps, ref_steps in pairs:
        got = [port_sc.auto_step_mode(st) for st in port_steps]
        want = [ref_sc.auto_step_mode(st) for st in ref_steps]
        assert got == want
        promoted += got.count("strassen")
    # the PEPS stems and the cell's Strassen step, only when nothing is forced
    assert (promoted > 0) == (force in (None, "auto"))


@pytest.mark.parametrize("cfg", [SMALL, SIXTEEN, WIDE], ids=_ids([SMALL, SIXTEEN, WIDE]))
@pytest.mark.parametrize("mode", ["split32", "split64", "native64"])
def test_prelude_matches_reference(cfg, mode):
    """The prelude's cached intermediates, run on torch, against the
    reference's complex128 numpy prelude on the same leaves."""
    both = _both(cfg)
    port_hp, ref_hp = _hoisted(cfg)
    want = ref_hoist.run_prelude(np, ref_hp, [np.asarray(a, np.complex128)
                                              for a in both["ref"]["arrays"]])
    split = mode.startswith("split")
    dtype = "complex64" if mode == "split32" else "complex128"
    full = place_buffers(both["port"]["arrays"], dtype, split, "cpu")
    with torch.inference_mode():
        got = port_hoist.run_prelude(port_hp, full, split_complex=split)
    assert len(got) == len(want) == port_hp.residual.program.num_inputs
    tol = 1e-5 if mode == "split32" else 1e-12
    for g, w in zip(got, want):
        g = (torch.complex(*g) if split else g).numpy().astype(np.complex128)
        assert g.shape == np.shape(w)
        assert np.max(np.abs(g - w)) <= tol * np.max(np.abs(w))


@pytest.mark.parametrize("cfg", [SMALL, SIXTEEN, WIDE], ids=_ids([SMALL, SIXTEEN, WIDE]))
def test_hoisted_oracle_equals_unhoisted(cfg):
    """The numpy oracle runs the same steps in the same order hoisted or
    not, so the sums are equal; and both equal the reference's."""
    port = _both(cfg)["port"]
    plain = NumpyBackend().execute_sliced(port["sp"], port["arrays"])
    hoisted = NumpyBackend().execute_sliced(port["sp"], port["arrays"], hoist=True)
    assert abs(_scalar(hoisted) - _scalar(plain)) <= 1e-13 * abs(_scalar(plain))
    from tnc_tpu.ops.backends import NumpyBackend as RefNumpyBackend

    ref = _both(cfg)["ref"]
    want = _scalar(RefNumpyBackend().execute_sliced(ref["sp"], ref["arrays"], hoist=True))
    assert abs(_scalar(hoisted) - want) <= 1e-12 * abs(want)


@pytest.mark.parametrize("cfg", [SMALL, SIXTEEN], ids=_ids([SMALL, SIXTEEN]))
def test_hoisted_gives_the_residual_and_its_inputs(cfg):
    """``hoisted``, the one hoist dispatch of every sliced executor: the
    residual program and the buffers ``run_prelude`` assembles, with the
    caller's leaves left as they were."""
    port = _both(cfg)["port"]
    full = [np.asarray(a, np.complex128) for a in port["arrays"]]
    before = list(full)
    sp, buffers = port_hoist.hoisted(port["sp"], full)
    hp = port_hoist.hoist_sliced_program(port["sp"])
    assert sp is hp.residual
    want = port_hoist.run_prelude(hp, before)
    assert len(buffers) == len(want) == sp.program.num_inputs
    assert all(np.array_equal(g, w) for g, w in zip(buffers, want))
    assert all(a is b for a, b in zip(full, before))
