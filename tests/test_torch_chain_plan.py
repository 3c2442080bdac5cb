"""The chain kernel's plan (``tnc_tpu_torch.ops.cuda_complex._ChainPlan``)
on the CPU: the host tables of every chain the port's paths launch, replayed
in torch as the kernel runs them (``tests/_torch_chain_cases.py``: its
per-stage thread shape, K splits, fetches into shared memory and fold
order), against the plain version and the JAX package's ``fused_chain_kl``
in Pallas interpret mode; the grid form and segmented chains; where the
plan puts the boundary between the two forms; and the once-planned chain
run of ``split_complex`` (which buffer parts it reads, and when it must
plan again).

The CUDA kernel itself runs only on a GPU (``tests/test_torch_cuda.py``,
``chip_smoke.py``). Tolerances: float32 max|Δ| ≤ 1e-5·max|ref| (different
summation orders of f32 products), float64 ≤ 1e-12·max|ref|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tnc_tpu.ops.pallas_complex as ref_pc
from tnc_tpu_torch.ops import cuda_complex as cc
from tnc_tpu_torch.ops import split_complex as port_sc

from tests._torch_chain_cases import (
    GRID_CHAIN,
    PATH_CHAINS,
    make_chain,
    replay_chain,
    stages_of,
)

TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


def _close(got, want, dtype):
    got = [np.asarray(g, dtype=np.float64) for g in got]
    want = [np.asarray(w, dtype=np.float64) for w in want]
    for g, w in zip(got, want):
        assert g.shape == w.shape
    scale = max(float(np.max(np.abs(w))) for w in want)
    err = max(float(np.max(np.abs(g - w))) for g, w in zip(got, want))
    assert err <= TOL[dtype] * scale, (err, scale)


def _flat(first, link_ops):
    return list(first) + [t for pair in link_ops for t in pair]


def _pallas_rows(first, link_ops, links, batch):
    """``fused_chain_kl`` in interpret mode, row by row over the batch."""
    ref_links = [ref_pc.ChainLink(*link.key()) for link in links]
    rows = []
    for z in range(batch or 1):
        def row(t):
            return jnp.asarray((t[z] if t.dim() == 3 else t).numpy())

        rows.append(ref_pc.fused_chain_kl(
            tuple(row(t) for t in first), [(row(a), row(b)) for a, b in link_ops],
            ref_links, interpret=True))
    if batch is None:
        return rows[0]
    return tuple(np.stack([np.asarray(r[j]) for r in rows]) for j in range(2))


@pytest.mark.parametrize("batch", [None, 3], ids=["unbatched", "batch3"])
@pytest.mark.parametrize("name", list(PATH_CHAINS))
def test_path_chains_replay_to_reference_and_pallas(name, batch):
    """Every chain shape the paths launch, unbatched and over a batch of 3:
    the resident plan's tables, replayed as the kernel runs them, equal the
    plain version (float64) and ``fused_chain_kl`` in interpret mode
    (float32)."""
    stages = PATH_CHAINS[name]
    for dtype in (torch.float64, torch.float32):
        first, link_ops, links = make_chain(stages, dtype, batch, seed=len(name))
        plan = cc._ChainPlan(first, link_ops, links)
        assert plan.forms == (cc.CHAIN_RESIDENT,)
        assert plan.n_stages == len(stages) and plan.batch == batch
        got = replay_chain(plan, _flat(first, link_ops))
        want = cc.fused_chain_reference(first, link_ops, links)
        _close(got, want, dtype)
        if dtype == torch.float32:
            _close(got, _pallas_rows(first, link_ops, links, batch), dtype)


@pytest.mark.parametrize("batched", ["head", "links"])
@pytest.mark.parametrize("k_axis", [0, 1])
def test_path_chains_shared_operands_and_strides(batched, k_axis):
    """The same chains with only the head's or only the links' operands
    batched (the others read by every row, batch stride 0), every operand a
    transposed view, and each link contracting either axis of the carried
    value."""
    for idx, stages in enumerate(PATH_CHAINS.values()):
        first, link_ops, links = make_chain(stages, torch.float64, 3, batched,
                                            k_axes=[k_axis], transposed=True, seed=idx)
        plan = cc._ChainPlan(first, link_ops, links)
        got = replay_chain(plan, _flat(first, link_ops))
        _close(got, cc.fused_chain_reference(first, link_ops, links), torch.float64)


def test_the_hard_case_is_shaped_to_its_work():
    """sycamore20_m8_t17's chain: the head gives each thread 8 x 2 outputs
    (its 8-value slow rows read as vectors from shared memory, where the
    head's (256, 8) operand and the link's are fetched), 2 threads
    splitting K; the 2048-long link splits K over the block's 256
    threads."""
    first, link_ops, links = make_chain(PATH_CHAINS["m8_t17 (256,8,256)"], torch.float32, 8)
    plan = cc._ChainPlan(first, link_ops, links)
    assert plan.stages == [cc.ChainStageShape(False, 8, 2, 2), cc.ChainStageShape(False, 1, 256)]
    hdr, (head, link) = stages_of(plan.launches[0].table)
    assert hdr["form"] == 0 and hdr["grid"] == 8
    assert head["vec"] == 1 and head["a"]["re"] >= 0 and head["b"]["re"] < 0
    assert link["a"]["slot"] < 0 and link["b"]["re"] >= 0  # carried, fetched


# stages whose outputs each thread takes 8 x 2 of, 2 threads splitting K:
# an odd number of fast columns (the last thread's second column absent),
# two passes of the block, a K of 5 partial sums per split thread
TWO_COLUMN_CHAINS = [
    [(64, 16, 129), (2064, 1, 1)],
    [(128, 8, 255), (2040, 1, 1)],
    [(160, 8, 256), (2048, 1, 1)],
]


@pytest.mark.parametrize("batch", [None, 3], ids=["unbatched", "batch3"])
@pytest.mark.parametrize("stages", TWO_COLUMN_CHAINS, ids=["129", "255", "k160"])
def test_two_column_stages_replay_to_reference(stages, batch):
    """Heads shaped 8 x 2 outputs a thread with K split in two replay to the
    plain version, ragged columns and several passes included."""
    for dtype in (torch.float64, torch.float32):
        first, link_ops, links = make_chain(stages, dtype, batch, seed=stages[0][2])
        plan = cc._ChainPlan(first, link_ops, links)
        assert plan.stages[0].tn == 2 and plan.stages[0].ks == 2
        _close(replay_chain(plan, _flat(first, link_ops)),
               cc.fused_chain_reference(first, link_ops, links), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_grid_form_replays_to_reference(dtype):
    """A chain whose carried value exceeds shared memory takes the grid
    form, with the long link's K split over blocks (partials added in split
    order); a small budget sends the path chains there too, and a chain of
    more stages than one launch takes runs in several launches, the carried
    value handed over in scratch."""
    first, link_ops, links = make_chain(GRID_CHAIN, dtype, seed=3)
    plan = cc._ChainPlan(first, link_ops, links)
    assert plan.forms == (cc.CHAIN_GRID,)
    _, stages = stages_of(plan.launches[0].table)
    assert stages[1]["kb"] > 1 and stages[1]["ks"] == cc.CHAIN_THREADS
    _close(replay_chain(plan, _flat(first, link_ops)),
           cc.fused_chain_reference(first, link_ops, links), dtype)
    for idx, stages in enumerate(list(PATH_CHAINS.values())[::3]):
        first, link_ops, links = make_chain(stages, dtype, 2, seed=idx)
        plan = cc._ChainPlan(first, link_ops, links, smem=256, sms=16)
        assert plan.forms == (cc.CHAIN_GRID,)
        _close(replay_chain(plan, _flat(first, link_ops)),
               cc.fused_chain_reference(first, link_ops, links), dtype)
    long = [(4, 4, 4)] * (cc.CHAIN_STAGES_PER_LAUNCH + 4)
    for smem, form in ((cc.MAX_SMEM_BYTES, cc.CHAIN_RESIDENT), (256, cc.CHAIN_GRID)):
        first, link_ops, links = make_chain(long, dtype, 2, seed=5)
        plan = cc._ChainPlan(first, link_ops, links, smem=smem, sms=16)
        assert plan.forms == (form, form)
        _close(replay_chain(plan, _flat(first, link_ops)),
               cc.fused_chain_reference(first, link_ops, links), dtype)


# a two-stage chain (K=2 head, then a dot of the whole carried value to a
# scalar) whose carried value is C = M * N values: the largest C whose two
# planes (each rounded to 16 bytes) and the 256-thread reduction buffer fit
# 232,448 bytes, and one more
FORM_EDGE = {
    torch.float32: [((2, 120, 240), True), ((2, 83, 347), False)],  # C = 28800, 28801
    torch.float64: [((2, 64, 223), True), ((2, 7, 2039), False)],  # C = 14272, 14273
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_resident_exactly_when_the_carried_values_fit(dtype):
    """The resident form is chosen exactly when the carried values (x 2 for
    re, im, at the element size) and the reduction buffer fit one block's
    shared memory; float64 halves the values that fit."""
    isz = torch.empty((), dtype=dtype).element_size()
    for head, fits in FORM_EDGE[dtype]:
        c = head[1] * head[2]
        first, link_ops, links = make_chain([head, (c, 1, 1)], dtype, seed=c)
        plan = cc._ChainPlan(first, link_ops, links)
        need = 2 * (-(-c * isz // 16) * 16) + 2 * cc.CHAIN_THREADS * isz
        assert (need <= cc.MAX_SMEM_BYTES) == fits
        assert plan.forms == ((cc.CHAIN_RESIDENT,) if fits else (cc.CHAIN_GRID,))
        if fits:
            assert plan.launches[0].table[4] <= cc.MAX_SMEM_BYTES  # the block's bytes
        _close(replay_chain(plan, _flat(first, link_ops)),
               cc.fused_chain_reference(first, link_ops, links), dtype)
    # the float64 edge's carried value is resident in float32
    head = FORM_EDGE[torch.float64][1][0]
    first, link_ops, links = make_chain([head, (head[1] * head[2], 1, 1)], torch.float32)
    assert cc._ChainPlan(first, link_ops, links).forms == (cc.CHAIN_RESIDENT,)


@pytest.mark.parametrize("k", [1, 2, 3, 16, 17, 2048, 65536])
@pytest.mark.parametrize("mn", [(1, 1), (1, 7), (8, 8), (3, 50), (8, 256), (256, 8), (64, 64),
                                (300, 300)])
def test_stage_shapes_leave_no_idle_work(k, mn):
    """Every stage shape: ``ks`` a power of two that no thread exceeds K
    with (so no thread sums only zeros) and the outputs x ``ks`` within the
    block; ``tm`` no larger than the slow extent needs, and 1 where K is
    split."""
    m, n = mn
    sh = cc.chain_stage_shape(k, m, n)
    s, f = (n, m) if sh.slow_b else (m, n)
    assert f >= s
    assert sh.ks & (sh.ks - 1) == 0 and 1 <= sh.ks <= k
    assert sh.ks == 1 or sh.tm * sh.tn == 1 or (sh.tm, sh.tn, sh.ks) == (8, 2, 2)
    if m * n <= cc.CHAIN_THREADS // 2:
        assert m * n * sh.ks <= cc.CHAIN_THREADS < m * n * sh.ks * 2 or sh.ks * 2 > k
    elif sh.tn == 2:  # both split threads have two chunks of K each
        assert k >= 4 * cc.CHAIN_FOLD and -(-s // 8) * -(-f // 2) * 2 >= cc.CHAIN_THREADS
    else:
        assert sh.ks == 1 and sh.tm <= max(1, s)
        groups = -(-s // sh.tm) * f
        assert groups <= cc.CHAIN_THREADS or sh.tm == 8 or 2 * sh.tm > s


@pytest.fixture(scope="module")
def chain12():
    """The last chain of a 12-qubit random-circuit statevector program,
    with random buffers for the slots it reads."""
    from tnc_tpu_torch.builders.connectivity import ConnectivityLayout
    from tnc_tpu_torch.builders.random_circuit import random_circuit
    from tnc_tpu_torch.contractionpath.paths import Greedy, OptMethod
    from tnc_tpu_torch.ops.program import build_program

    tn = random_circuit(12, 12, 0.4, 0.4, np.random.default_rng(42),
                        ConnectivityLayout.SYCAMORE, bitstring="*" * 12)
    program = build_program(tn, Greedy(OptMethod.GREEDY).find_path(tn).replace_path())
    s, e = port_sc.plan_kernels(program).chains[-1]
    return program, program.steps[s:e]


def _buffers(program, steps, batch=None, seed=0):
    rng = np.random.default_rng(seed)
    specs, _ = port_sc._chain_specs(steps)
    bufs = [None] * program.num_inputs
    for slot, view, *_ in specs:
        shape = ((batch,) if batch else ()) + (int(np.prod(view)),)
        bufs[slot] = tuple(torch.from_numpy(rng.standard_normal(shape)) for _ in range(2))
    return bufs


@pytest.mark.parametrize("batch", [None, 3])
def test_planned_chain_run_reads_the_buffers_in_place(chain12, batch):
    """``_ChainRun`` plans a chain group once: an operand part that is a
    view of its buffer part is read at a fixed byte offset there (a call
    only fills its pointer; an operand whose prep copies is prepped again
    on every call), its plan writes the last step's stored shape (after the batch), and its
    tables replay to the chain's plain result."""
    program, steps = chain12
    bufs = _buffers(program, steps, batch)
    batched = {slot for slot, *_ in port_sc._chain_specs(steps)[0]} if batch else set()
    run = port_sc._ChainRun(steps, bufs, batched)
    first, link_ops, links = port_sc.chain_operands(steps, bufs, batched)
    flat = _flat(first, link_ops)
    lead = (batch,) if batch else ()
    assert run.plan.out_shape == lead + tuple(steps[-1].out_store)
    for j, ((slot, *_), read) in enumerate(zip(run.specs, run.reads)):
        for part in range(2):
            op, src = flat[2 * j + part], bufs[slot][part]
            if read is None:  # its prep copies: redone on every call
                assert op.untyped_storage().data_ptr() != src.untyped_storage().data_ptr()
            else:
                assert op.data_ptr() == src.data_ptr() + read[part]
    assert any(read is not None for read in run.reads)
    got = replay_chain(run.plan, flat)
    want = cc.fused_chain_reference(first, link_ops, links)
    _close(got, [w.reshape(run.plan.out_shape) for w in want], torch.float64)


def test_planned_chain_run_plans_again_when_the_buffers_change(chain12):
    """A planned run matches the buffers it was planned on and new buffers of
    the same layout; another batch, a batched flag, a dtype or strides of
    any source part need a new plan (as would another device)."""
    program, steps = chain12
    bufs = _buffers(program, steps)
    run = port_sc._ChainRun(steps, bufs, set())
    assert run.matches(bufs, set())
    assert run.matches(_buffers(program, steps, seed=1), set())
    assert not run.matches(_buffers(program, steps, batch=2), set())
    for slot in run.sources:
        assert not run.matches(bufs, {slot})
        other = list(bufs)
        other[slot] = (bufs[slot][0], bufs[slot][1].float())
        assert not run.matches(other, set())
        n = bufs[slot][0].numel()
        other[slot] = tuple(torch.empty(2 * n, dtype=t.dtype)[::2].copy_(t) for t in bufs[slot])
        assert not run.matches(other, set())


def test_cpu_chain_runs_the_plain_version_and_counts_nothing(chain12):
    """On CPU tensors ``fused_chain`` runs the plain version (with or without
    a plan) and launches nothing; ``run_chain_split`` keeps no planned run
    there; ``reset_launches`` clears the count per form too."""
    cc.CHAIN_FORMS[cc.CHAIN_RESIDENT] = 5
    cc.reset_launches()
    assert cc.CHAIN_FORMS == {cc.CHAIN_RESIDENT: 0, cc.CHAIN_GRID: 0}
    first, link_ops, links = make_chain(PATH_CHAINS["loop (4,4,4)"], torch.float64)
    want = cc.fused_chain_reference(first, link_ops, links)
    for plan in (None, cc.chain_plan(first, link_ops, links)):
        got = cc.fused_chain(first, link_ops, links, plan)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    program, steps = chain12
    runs: dict = {}
    bufs = _buffers(program, steps)
    out = port_sc.run_chain_split(steps, list(bufs), set(), runs, 0)
    assert runs == {} and out[0].shape == tuple(steps[-1].out_store)
    assert cc.LAUNCHES["fused_chain"] == 0
    assert cc.CHAIN_FORMS == {cc.CHAIN_RESIDENT: 0, cc.CHAIN_GRID: 0}
