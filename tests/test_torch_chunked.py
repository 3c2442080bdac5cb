"""The port's chunked, slice-batched sliced executor
(``tnc_tpu_torch.ops.chunked``), its memory budget
(``tnc_tpu_torch.ops.budget``) and the slice-batch axis of the step
arithmetic, against the JAX package on the CPU.

- ``split_program`` gives the reference's chunks; ``program_peak_bytes``,
  ``clamp_slice_batch`` and ``fits_hbm`` give the reference's numbers with
  its TPU lane padding set to 1 (a CUDA buffer is not tiled).
- A batched step (either side, or both, carrying a leading slice axis)
  equals a loop over the batch of unbatched steps, in every mode; the
  batched plain chain equals the reference's plain chain under
  ``jax.vmap``.
- ``TorchBackend(device="cpu", split_complex=True)``, whose default sliced
  path is the reference's (the stem hoisted, the residual chunked and
  batched), agrees with the reference's default ``JaxBackend`` and its
  ``NumpyBackend`` within 1e-5 relative (float32 parts), and with float64
  parts with the port's complex128 oracle within 1e-12 relative, at slice
  batches 1, 3 and 8, chunks of 4 and 64 steps, hoisted or not.

Configurations: ``sycamore_circuit(20, 6, rng 7)`` sliced to 2^7 (4
slices; 2 chains in the residual), ``sycamore_circuit(20, 8, rng 7)`` to
2^17 (16 slices; 1 chain) and to 2^14 (256 slices); the plan-level checks
also take the 53-qubit depth-10 cell (128 slices).
"""

import doctest
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tnc_tpu.ops.budget as ref_budget
import tnc_tpu.ops.chunked as ref_chunked
import tnc_tpu.ops.pallas_complex as ref_pc
import tnc_tpu_torch.ops.budget as port_budget
import tnc_tpu_torch.ops.chunked as port_chunked
import tnc_tpu_torch.ops.cuda_complex as port_cuda
import tnc_tpu_torch.ops.split_complex as port_sc
import tnc_tpu_torch.ops.strassen as port_strassen
from tnc_tpu.ops.backends import JaxBackend
from tnc_tpu.ops.backends import NumpyBackend as RefNumpyBackend
from tnc_tpu.ops.hoist import hoist_sliced_program as ref_hoist
from tnc_tpu_torch.ops.backends import NumpyBackend, TorchBackend, apply_step
from tnc_tpu_torch.ops.hoist import hoist_sliced_program
from tnc_tpu_torch.ops.program import step_dims
from tnc_tpu_torch.tensornetwork.contraction import contract_tensor_network_sliced
from tests._torch_sliced_cases import CELL, SIXTEEN, SMALL, WIDE, _both, _ids, _scalar

EXECUTED = [SMALL, SIXTEEN, WIDE]
PLANNED = [SMALL, SIXTEEN, CELL]
STEP_FIELDS = ("lhs", "rhs", "a_view", "a_perm", "a_dot", "a_cfirst", "b_view",
               "b_perm", "b_dot", "b_cfirst", "swap", "out_store")


def _programs(cfg):
    """The sliced program and its hoisted residual, port and reference."""
    both = _both(cfg)
    port, ref = both["port"]["sp"], both["ref"]["sp"]
    return [(port, ref), (hoist_sliced_program(port).residual, ref_hoist(ref).residual)]


# -- plans -----------------------------------------------------------------------


@pytest.mark.parametrize("chunk_steps", [4, 16, 64])
@pytest.mark.parametrize("cfg", PLANNED, ids=_ids(PLANNED))
def test_split_program_matches_reference(cfg, chunk_steps):
    for port, ref in _programs(cfg):
        got = port_chunked.split_program(port.program, chunk_steps)
        want = ref_chunked.split_program(ref.program, chunk_steps)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert (g.in_slots, g.out_slots) == (w.in_slots, w.out_slots)
            for a, b in zip(g.steps, w.steps, strict=True):
                assert all(getattr(a, f) == getattr(b, f) for f in STEP_FIELDS)


def test_module_doctests():
    """The executor's and the budget's doctests, and those of the modules
    whose examples gained a batch axis (Strassen, the copy-mode rule)."""
    for module, least in ((port_chunked, 3), (port_budget, 1), (port_strassen, 6),
                          (port_cuda, 20)):
        result = doctest.testmod(module)
        assert result.failed == 0 and result.attempted >= least


@pytest.mark.parametrize("cfg", PLANNED, ids=_ids(PLANNED))
def test_budget_matches_reference_without_lane_padding(cfg, monkeypatch):
    """With the reference's TPU lane set to 1 its model is the port's: the
    same peak, peak step and bytes per slice of the batch; the same clamp
    and fit at every budget."""
    monkeypatch.setattr(ref_budget, "_LANE", 1)
    for port, ref in _programs(cfg):
        for split, width, batch in ((True, 4, 1), (True, 4, 8), (False, 16, 3)):
            kw = {"split_complex": split, "dtype_bytes": width}
            got = port_budget.program_peak_bytes(port.program, batch=batch, **kw)
            want = ref_budget.program_peak_bytes(ref.program, batch=batch, **kw)
            assert (got.peak_bytes, got.peak_step, got.bytes_per_batch_unit) == (
                want.peak_bytes, want.peak_step, want.bytes_per_batch_unit)
        unit = port_budget.program_peak_bytes(port.program).bytes_per_batch_unit
        for hbm in (80 << 30, 16 << 30, 10 * unit, 3 * unit, unit):
            for request in (1, 3, 8, 64):
                assert port_budget.clamp_slice_batch(port.program, request, hbm_bytes=hbm) == \
                    ref_budget.clamp_slice_batch(ref.program, request, hbm_bytes=hbm)
            for batch in (1, 8):
                assert port_budget.fits_hbm(port.program, batch=batch, hbm_bytes=hbm) == \
                    ref_budget.fits_hbm(ref.program, batch=batch, hbm_bytes=hbm)


def test_cell_batch_of_8_fits_the_card():
    """The cell's residual at the default batch of 8 fits 0.75 of an 80 GiB
    card; the model's per-slice peak is near what the card measured for
    one slice of the unhoisted loop (5.64 GB, PERF.md)."""
    residual = hoist_sliced_program(_both(CELL)["port"]["sp"]).residual.program
    est = port_budget.program_peak_bytes(residual)
    assert 4e9 < est.bytes_per_batch_unit < 6e9
    assert port_budget.clamp_slice_batch(residual, 8, hbm_bytes=80 << 30) == 8
    assert port_budget.clamp_slice_batch(residual, 64, hbm_bytes=80 << 30) < 16


def test_device_hbm_bytes(monkeypatch):
    monkeypatch.delenv("TNC_TPU_HBM_BYTES", raising=False)
    assert port_budget.device_hbm_bytes("cpu") == 64 << 30
    monkeypatch.setenv("TNC_TPU_HBM_BYTES", "12345")
    assert port_budget.device_hbm_bytes("cpu") == 12345


@pytest.mark.parametrize("cfg", [SMALL, SIXTEEN], ids=_ids([SMALL, SIXTEEN]))
@pytest.mark.parametrize("chunk_steps", [4, 64])
def test_chunk_plan_batches_what_the_slices_reach(cfg, chunk_steps):
    """Unhoisted, the chunks that touch no sliced data run unbatched; a
    sliced leaf is gathered in the chunk that first reads it and never
    again; the residual of the hoisted program is batched throughout."""
    sp = _both(cfg)["port"]["sp"]
    plans = port_chunked.chunk_plan(sp, 4, chunk_steps, True, "float32")
    gathered = [slot for cp in plans for slot in cp.leaf_in]
    read = {slot for cp in plans for st in cp.chunk.steps for slot in (st.lhs, st.rhs)}
    assert sorted(gathered) == sorted(s for s in read if sp.slot_slices[s])
    assert len(gathered) == len(set(gathered))
    for cp in plans:
        assert set(cp.leaf_in) <= cp.batched_in
    if chunk_steps == 4:  # chunks of the stem alone read no sliced data
        assert [bool(cp.batched_in) for cp in plans][:4] == [True, False, True, False]
    residual = hoist_sliced_program(sp).residual
    assert all(cp.batched_in for cp in port_chunked.chunk_plan(
        residual, 4, chunk_steps, True, "float32"))
    assert port_chunked.chunk_plan(sp, 4, chunk_steps, True, "float32") is plans


# -- the batch axis of the step arithmetic ------------------------------------------


def _step_pairs(steps, batch, a_b, b_b, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)

    def pair(view, batched):
        shape = ((batch,) if batched else ()) + (int(np.prod(view)),)
        return tuple(torch.from_numpy(rng.standard_normal(shape).astype(dtype))
                     for _ in range(2))

    return [(pair(st.a_view, a_b), pair(st.b_view, b_b)) for st in steps]


def _row(pair, batched, z):
    return tuple(p[z] for p in pair) if batched else pair


@pytest.mark.parametrize("sides", ["a", "b", "both"])
@pytest.mark.parametrize("mode", ["naive", "gauss", "strassen", "fused", "fused_transpose"])
def test_batched_step_equals_a_loop_over_the_batch(mode, sides, monkeypatch):
    """Every step of the 16-slice program, with the batch axis on the
    a side, the b side or both: the batched step equals the unbatched step
    on each row, in float64 within 1e-12 of max|row|, and the routed
    counts count each row. (The Strassen crossover is lowered so the
    small steps take the batched quadrant path.)"""
    monkeypatch.setattr(port_strassen, "STRASSEN_MIN_DIM", 2)
    batch = 3
    a_b, b_b = sides in ("a", "both"), sides in ("b", "both")
    steps = _both(SIXTEEN)["port"]["sp"].program.steps
    for i, (st, (a, b)) in enumerate(zip(steps, _step_pairs(steps, batch, a_b, b_b, 7))):
        port_sc.reset_routed()
        got = port_sc.apply_step_split(a, b, st, mode=mode, a_batched=a_b, b_batched=b_b)
        routed = (dict(port_sc.FUSED_ROUTED), dict(port_sc.FUSED_TRANSPOSE_ROUTED))
        port_sc.reset_routed()
        assert tuple(got[0].shape) == (batch,) + tuple(st.out_store)
        for z in range(batch):
            want = port_sc.apply_step_split(_row(a, a_b, z), _row(b, b_b, z), st, mode=mode)
            scale = max(float(w.abs().max()) for w in want)
            err = max(float((g[z] - w).abs().max()) for g, w in zip(got, want))
            assert err <= 1e-12 * scale, (i, z, err, scale)
        once = (dict(port_sc.FUSED_ROUTED), dict(port_sc.FUSED_TRANSPOSE_ROUTED))
        assert routed[0] == once[0]
        if mode == "fused_transpose":
            # a batched step never reaches the transpose kernel
            assert sum(routed[1].values()) == batch
        else:
            assert routed[1] == {}


@pytest.mark.parametrize("sides", ["a", "b", "both"])
def test_batched_native_step_equals_a_loop(sides):
    """The native-complex step (``split_complex=False``) takes the batch
    axis the same way."""
    batch = 2
    a_b, b_b = sides in ("a", "both"), sides in ("b", "both")
    steps = _both(SIXTEEN)["port"]["sp"].program.steps
    for st, (a, b) in zip(steps, _step_pairs(steps, batch, a_b, b_b, 8)):
        a, b = torch.complex(*a), torch.complex(*b)
        got = apply_step(a, b, st, a_b, b_b)
        for z in range(batch):
            want = apply_step(a[z] if a_b else a, b[z] if b_b else b, st)
            assert torch.allclose(got[z], want, rtol=0, atol=1e-12 * float(want.abs().max()))


@pytest.mark.parametrize("which", ["head", "links", "all"])
def test_batched_chain_reference_matches_reference_vmap(which):
    """The residual chains of the 4-slice program, with a batch axis on the
    head's operands, on the link operands or on all: the port's plain chain
    equals the reference's plain chain under ``jax.vmap`` (float32, within
    1e-5 of max|ref|), and the wrapper on CPU tensors gives the same."""
    residual = hoist_sliced_program(_both(SMALL)["port"]["sp"]).residual.program
    policy = port_sc.plan_kernel_steps(residual.steps)
    assert len(policy.chains) == 2
    batch = 3
    for idx, (s, e) in enumerate(policy.chains):
        steps = residual.steps[s:e]
        rng = np.random.default_rng(idx)
        buffers = [None] * residual.num_inputs
        batched = set()
        for st in steps:
            for slot, view in ((st.lhs, st.a_view), (st.rhs, st.b_view)):
                if buffers[slot] is None:
                    head = slot in (steps[0].lhs, steps[0].rhs)
                    on = which == "all" or (which == "head") == head
                    shape = ((batch,) if on else ()) + (int(np.prod(view)),)
                    buffers[slot] = tuple(
                        torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                        for _ in range(2))
                    if on:
                        batched.add(slot)
        first_ops, link_ops, links = port_sc.chain_operands(steps, buffers, batched)
        got = port_cuda.fused_chain_reference(first_ops, link_ops, links)
        wrapped = port_cuda.fused_chain(first_ops, link_ops, links)
        f_axes = tuple(0 if t.dim() == 3 else None for t in first_ops)
        l_axes = [tuple(0 if t.dim() == 3 else None for t in pair) for pair in link_ops]
        ref_links = [ref_pc.ChainLink(*link.key()) for link in links]
        want = jax.vmap(lambda f, lk: ref_pc.fused_chain_reference(f, lk, ref_links),
                        in_axes=(f_axes, l_axes))(
            tuple(jnp.asarray(t.numpy()) for t in first_ops),
            [tuple(jnp.asarray(t.numpy()) for t in pair) for pair in link_ops])
        scale = max(float(np.max(np.abs(np.asarray(w)))) for w in want)
        for g, r, w in zip(got, wrapped, want):
            assert g.shape == (batch,) + tuple(np.shape(w))[1:]
            assert float(np.max(np.abs(g.numpy() - np.asarray(w)))) <= 1e-5 * scale
            assert torch.equal(g, r)


# -- the executor ---------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _reference(cfg):
    """The reference's default JaxBackend (hoisted, chunked, batch 8) and
    its complex128 oracle on one configuration."""
    ref = _both(cfg)["ref"]
    jax_out = JaxBackend(split_complex=True).execute_sliced(ref["sp"], ref["arrays"])
    return _scalar(jax_out), _scalar(RefNumpyBackend().execute_sliced(ref["sp"], ref["arrays"]))


@functools.lru_cache(maxsize=None)
def _port_oracle(cfg):
    port = _both(cfg)["port"]
    return _scalar(NumpyBackend().execute_sliced(port["sp"], port["arrays"]))


def _chunked(cfg, dtype="complex64", **kw):
    port = _both(cfg)["port"]
    return TorchBackend(dtype=dtype, device="cpu", split_complex=True, **kw).execute_sliced(
        port["sp"], port["arrays"])


@pytest.mark.parametrize("hoist", [True, False], ids=["hoisted", "unhoisted"])
@pytest.mark.parametrize("chunk_steps", [4, 64])
@pytest.mark.parametrize("slice_batch", [1, 3, 8])
@pytest.mark.parametrize("cfg", EXECUTED, ids=_ids(EXECUTED))
def test_chunked_matches_reference(cfg, slice_batch, chunk_steps, hoist):
    jax_amp, numpy_amp = _reference(cfg)
    got = _scalar(_chunked(cfg, slice_batch=slice_batch, chunk_steps=chunk_steps, hoist=hoist))
    assert abs(got - jax_amp) <= 1e-5 * abs(jax_amp)
    assert abs(got - numpy_amp) <= 1e-5 * abs(numpy_amp)
    want = _port_oracle(cfg)
    got64 = _scalar(_chunked(cfg, "complex128", slice_batch=slice_batch,
                             chunk_steps=chunk_steps, hoist=hoist))
    assert abs(got64 - want) <= 1e-12 * abs(want)


@pytest.mark.parametrize("cfg", [SMALL, SIXTEEN], ids=_ids([SMALL, SIXTEEN]))
def test_native_complex_chunked_matches_port_oracle(cfg):
    port = _both(cfg)["port"]
    for kw in ({}, {"slice_batch": 3, "chunk_steps": 4}, {"hoist": False}):
        got = _scalar(TorchBackend(dtype="complex128", device="cpu", split_complex=False, **kw)
                      .execute_sliced(port["sp"], port["arrays"]))
        assert abs(got - _port_oracle(cfg)) <= 1e-12 * abs(_port_oracle(cfg))


@pytest.mark.parametrize("kw", [{"max_slices": 2}, {"max_slices": 99}, {"max_slices": 11},
                                {"slice_range": (1, 3)}, {"slice_range": (3, 9)},
                                {"slice_range": (5, 16)}, {"slice_range": (2, 2)}],
                         ids=["max2", "max99", "max11", "range1-3", "range3-9",
                              "range5-16", "empty"])
def test_partial_sums_follow_reference(kw):
    """Partial sums under ``max_slices`` and ``slice_range`` on the 16-slice
    program: the port's chunked default against the reference's chunked
    default and its numpy oracle (batches cut to divisors of the span)."""
    port, ref = _both(SIXTEEN)["port"], _both(SIXTEEN)["ref"]
    want = np.asarray(RefNumpyBackend().execute_sliced(ref["sp"], ref["arrays"], **kw))
    jax_out = np.asarray(JaxBackend(split_complex=True).execute_sliced(
        ref["sp"], ref["arrays"], **kw))
    got = np.asarray(TorchBackend(device="cpu", split_complex=True).execute_sliced(
        port["sp"], port["arrays"], **kw))
    scale = max(float(np.max(np.abs(want))), 1e-30)
    assert np.max(np.abs(got - want)) <= 1e-5 * scale
    assert np.max(np.abs(got - jax_out)) <= 1e-5 * scale


def test_batch_follows_the_reference_divisor_rule():
    sp = _both(SIXTEEN)["port"]["sp"]
    assert port_chunked.resolve_batch(sp, 3, device="cpu") == (2, 0, 16)
    assert port_chunked.resolve_batch(sp, 8, device="cpu", max_slices=12) == (6, 0, 12)
    assert port_chunked.resolve_batch(sp, 8, device="cpu", slice_range=(3, 10)) == (7, 3, 10)
    assert port_chunked.resolve_batch(sp, 8, device="cpu", slice_range=(5, 5)) == (1, 5, 5)
    with pytest.raises(ValueError, match="exclusive"):
        port_chunked.resolve_batch(sp, 8, device="cpu", max_slices=2, slice_range=(0, 2))


def test_host_false_keeps_stored_shape_with_open_legs():
    """Two qubits left open: the chunked default returns a (re, im) pair in
    the program's stored shape on the device, the reference's JaxBackend
    the same; on the host both results agree with complex128."""
    q = SMALL[0]
    both = _both(SMALL, "0" * (q - 2) + "**")
    port, ref = both["port"], both["ref"]
    backend = TorchBackend(device="cpu", split_complex=True)
    re, im = backend.execute_sliced(port["sp"], port["arrays"], host=False)
    ref_dev = JaxBackend(split_complex=True).execute_sliced(ref["sp"], ref["arrays"], host=False)
    stored = port["sp"].program.stored_result_shape
    assert tuple(re.shape) == tuple(im.shape) == stored == tuple(ref_dev[0].shape)
    host = backend.execute_sliced(port["sp"], port["arrays"])
    want = RefNumpyBackend().execute_sliced(ref["sp"], ref["arrays"])
    assert host.shape == want.shape == port["sp"].program.result_shape
    assert np.max(np.abs(host - want)) <= 1e-5 * np.max(np.abs(want))
    assert np.allclose(torch.complex(re, im).numpy().reshape(host.shape), host)


def test_residual_chains_run_batched(monkeypatch):
    """4 slices in one batch: each of the residual's 2 chains is one
    ``fused_chain`` call on batched operands; 16 slices in batches of 8:
    its 1 chain is called once a batch."""
    calls = []
    chain = port_cuda.fused_chain

    def counting(first_ops, link_ops, links):
        calls.append(max(t.dim() for t in list(first_ops) + [x for p in link_ops for x in p]))
        return chain(first_ops, link_ops, links)

    monkeypatch.setattr(port_cuda, "fused_chain", counting)
    monkeypatch.delenv("TNC_TPU_COMPLEX_MULT", raising=False)
    _chunked(SMALL)
    assert calls == [3, 3]
    calls.clear()
    _chunked(SIXTEEN)
    assert calls == [3, 3]


@pytest.mark.parametrize("force", ["fused", "fused_transpose"])
def test_forced_rungs_count_per_slice(force, monkeypatch):
    """Under a forced rung the chunked, hoisted path routes the prelude's
    steps once and each residual step once per slice, by the same gate the
    unbatched steps go through; a batched step never reaches the transpose
    kernel; the sum still agrees with the default rung."""
    monkeypatch.setenv("TNC_TPU_COMPLEX_MULT", force)
    sp = _both(SIXTEEN)["port"]["sp"]
    hp = hoist_sliced_program(sp)
    prelude = [ps.step for ps in hp.prelude_steps]
    want_fused, want_transpose = {}, {}
    for steps, times in ((prelude, 1), (hp.residual.program.steps, sp.slicing.num_slices)):
        for st in steps:
            m, k, n = step_dims(st)
            if force == "fused":
                reason = ("layout" if not (st.a_cfirst and st.b_cfirst)
                          else port_cuda.ineligible_reason(k, *((n, m) if st.swap else (m, n))))
                if reason is not None:
                    want_fused[reason] = want_fused.get(reason, 0) + times
            else:
                reason = port_sc.fused_transpose_ineligible_reason(st) or (
                    "batch" if times > 1 else None)
                if reason is not None:
                    want_transpose[reason] = want_transpose.get(reason, 0) + times
    port_sc.reset_routed()
    got = _scalar(_chunked(SIXTEEN))
    assert port_sc.FUSED_ROUTED == want_fused
    assert port_sc.FUSED_TRANSPOSE_ROUTED == want_transpose
    monkeypatch.delenv("TNC_TPU_COMPLEX_MULT")
    default = _scalar(_chunked(SIXTEEN))
    assert abs(got - default) <= 1e-5 * abs(default)


def test_default_entry_point_runs_chunked_and_hoisted(monkeypatch):
    """``contract_tensor_network_sliced`` on a ``TorchBackend`` with its
    defaults runs the chunked executor hoisted: one call on the program,
    whose slice batches then run the residual (the prelude run once
    before them)."""
    calls, runs = [], []
    real_placed = port_chunked.run_sliced_chunked_placed
    real_run = port_chunked._run_chunked

    def spy_placed(sp, full, **kw):
        calls.append((len(sp.program.steps), kw["hoist"], kw["batch"], kw["chunk_steps"]))
        return real_placed(sp, full, **kw)

    def spy_run(sp, *args):
        runs.append(len(sp.program.steps))
        return real_run(sp, *args)

    monkeypatch.setattr(port_chunked, "run_sliced_chunked_placed", spy_placed)
    monkeypatch.setattr(port_chunked, "_run_chunked", spy_run)
    port = _both(SMALL)["port"]
    out = contract_tensor_network_sliced(port["tn"], port["path"], port["slicing"],
                                         TorchBackend(device="cpu", split_complex=True))
    residual = hoist_sliced_program(port["sp"]).residual
    assert calls == [(len(port["sp"].program.steps), True, 8, 64)]
    assert runs == [len(residual.program.steps)]
    want = _port_oracle(SMALL)
    assert abs(_scalar(out.data.into_data()) - want) <= 1e-5 * abs(want)


def test_unknown_strategy_is_refused():
    with pytest.raises(ValueError, match="sliced_strategy"):
        TorchBackend(device="cpu", sliced_strategy="vmap")


def test_execute_sliced_batched_places_and_sums():
    """The module's own entry point from host arrays: the amplitude in the
    result shape, or the stored-shape pair with ``host=False``; a program of
    one slice is refused (``TorchBackend.execute`` runs it)."""
    port = _both(SIXTEEN)["port"]
    got = port_chunked.execute_sliced_batched(port["sp"], port["arrays"], device="cpu",
                                              hoist=True)
    want = _port_oracle(SIXTEEN)
    assert got.shape == port["sp"].program.result_shape
    assert abs(_scalar(got) - want) <= 1e-5 * abs(want)
    re, im = port_chunked.execute_sliced_batched(port["sp"], port["arrays"], device="cpu",
                                                 host=False)
    assert tuple(re.shape) == port["sp"].program.stored_result_shape
    from tnc_tpu_torch.contractionpath.slicing import Slicing
    from tnc_tpu_torch.ops.sliced import build_sliced_program

    one = build_sliced_program(port["tn"], port["path"], Slicing((), ()))
    with pytest.raises(ValueError, match="sliced program"):
        port_chunked.execute_sliced_batched(one, port["arrays"], device="cpu")
