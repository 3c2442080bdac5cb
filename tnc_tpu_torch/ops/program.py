"""Contraction-path → static execution program compiler (the port's copy
of ``tnc_tpu.ops.program``).

The whole path is known before execution and every shape is static, so it
is compiled once into a :class:`ContractionProgram`: a flat list of
:class:`PairStep` dot-contractions that an executor runs in order.

The compiler's layout rules were shaped for the TPU, where an f32 array
is stored in (sublane×128-lane) tiles and a trailing dim < 128 pads up to
128 — hence stored forms whose minor dim is merged to ≥ 128, one aligned
macro transpose per operand (or none), contract-dim-leading or -trailing
dot operands, consumer-aligned free legs, and the staged ``a_ops`` /
``b_ops`` plans for operands whose plain transpose would pad badly. The
port keeps every rule unchanged, so its programs equal the reference's
step for step and :func:`chain_groups` forms the same chains. Its torch
executor runs each operand's plain view + permute + reshape and ignores
the staged plans (the same semantics; they exist only for TPU tiling).

Executors free each step's right-hand buffer as soon as the step has
consumed it (replace-left semantics).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from tnc_tpu_torch.contractionpath.contraction_path import ContractionPath
from tnc_tpu_torch.tensornetwork.tensor import CompositeTensor, LeafTensor, Tensor

_MIN_MINOR = 128  # f32 lane tile: trailing dims below this pad up to it
_STAGED_MIN_SIZE = 1 << 18  # staged prep only pays off for big operands
_STAGED_PAD_FACTOR = 4.0  # naive materialization tolerated up to this
# widest lane window the staged planner accepts (bounds the host-side
# index table; execution uses a gather above the matmul cap)
_LANEMIX_MAX_W = 65536


def step_dims(st) -> tuple[int, int, int]:
    """The ``(m, k, n)`` matmul shape of one :class:`PairStep`: the dot
    contracts a ``(m, k)`` lhs against a ``(k, n)`` rhs (orientation and
    ``swap`` folded out — these are the *logical* dims every cost shares).
    """
    k = st.a_dot[0] if st.a_cfirst else st.a_dot[-1]
    m = math.prod(st.a_dot) // max(k, 1)
    n = math.prod(st.b_dot) // max(k, 1)
    return int(m), int(k), int(n)


def step_flops(st) -> float:
    """Naive multiply-add count of one step: ``k * m * n``."""
    m, k, n = step_dims(st)
    return float(k) * float(m) * float(n)


def step_prep_elems(st) -> float:
    """Elements the step's operand *prep* moves through HBM on top of
    the dot itself: a materialized macro transpose (or staged op plan)
    reads the whole operand and writes the permuted copy — ``2 ×
    view`` elements per permuted operand. Zero for identity preps
    (reshape-only views). This is the pass the reference's
    ``fused_transpose`` kernel rung deletes.

    >>> from tnc_tpu_torch.tensornetwork.tensor import CompositeTensor, LeafTensor
    >>> from tnc_tpu_torch.contractionpath.contraction_path import ContractionPath
    >>> tn = CompositeTensor([LeafTensor.from_const([0, 1], 4),
    ...                       LeafTensor.from_const([1, 2], 4)])
    >>> program = build_program(tn, ContractionPath.simple([(0, 1)]))
    >>> step_prep_elems(program.steps[0])   # identity preps: no pass
    0.0
    """
    extra = 0.0
    for view, perm, ops in (
        (st.a_view, st.a_perm, st.a_ops),
        (st.b_view, st.b_perm, st.b_ops),
    ):
        if perm is not None or ops:
            extra += 2.0 * float(math.prod(view))
    return extra


def step_elems(st, mode: str | None = None) -> tuple[float, float]:
    """(elements read+moved, elements written) by one step — the
    operands' stored views in plus the prep pass
    (:func:`step_prep_elems`: a materialized macro transpose reads and
    writes the operand again before the dot sees it), the stored
    result out. Multiplied by the dtype width this is the step's
    predicted HBM traffic, the bytes side of the roofline next to
    :func:`step_flops`.

    ``mode`` is the kernel-ladder mode that will run the step:
    ``fused_transpose`` streams the permutation inside the kernel's
    index maps, so its prediction drops the prep pass — the saved
    traffic the spans and the roofline must credit."""
    elems_in = float(math.prod(st.a_view)) + float(math.prod(st.b_view))
    if mode != "fused_transpose":
        elems_in += step_prep_elems(st)
    return elems_in, float(math.prod(st.out_store))


def chain_groups(
    steps,
    max_flops: float | None = None,
    max_elems: float | None = None,
) -> tuple[tuple[int, int], ...]:
    """Runs of consecutive steps executable as ONE fused chain launch
    (:func:`tnc_tpu_torch.ops.cuda_complex.fused_chain`).

    A step extends the running chain when it consumes the chain's
    current value (its ``lhs`` or ``rhs`` is the chain's result slot —
    replace-left semantics guarantee that slot still holds the chained
    value), the carried operand's prep is a pure row-major regroup
    (no macro transpose, no staged ops — the carried value is only ever
    regrouped by a reshape), and the whole run stays small: every step
    strictly under the ``max_flops`` ceiling in the fused kernel's
    ``2*k*m*n`` units (default ``MIN_FLOPS`` — exactly the
    launch-dominated steps the single-step kernel rejects and the
    ``small`` shape bucket of :func:`tnc_tpu_torch.ops.split_complex.
    step_bucket`) with all operands + intermediates summing under
    ``max_elems`` float32 elements ((real, imag) pairs count double).

    Returns ``(start, end)`` index spans, each covering ≥ 2 steps;
    steps outside every span dispatch individually.

    >>> from tnc_tpu_torch.tensornetwork.tensor import CompositeTensor, LeafTensor
    >>> from tnc_tpu_torch.contractionpath.contraction_path import ContractionPath
    >>> tn = CompositeTensor([LeafTensor.from_const([0, 1], 4),
    ...                       LeafTensor.from_const([1, 2], 4),
    ...                       LeafTensor.from_const([2, 3], 4)])
    >>> program = build_program(tn, ContractionPath.simple([(0, 1), (0, 2)]))
    >>> chain_groups(program.steps)
    ((0, 2),)
    """
    if max_flops is None:
        from tnc_tpu_torch.ops.cuda_complex import MIN_FLOPS

        max_flops = float(MIN_FLOPS)
    if max_elems is None:
        from tnc_tpu_torch.ops.cuda_complex import CHAIN_MAX_ELEMS

        max_elems = float(CHAIN_MAX_ELEMS)

    def step_cost_elems(st) -> float:
        # on-chip *residency* of the step's operands and result — NOT
        # step_elems, whose total includes the HBM prep-pass traffic
        # (step_prep_elems): counting that here would shrink chain
        # admission for transpose-feeding steps for no footprint reason
        elems_in = float(math.prod(st.a_view)) + float(math.prod(st.b_view))
        elems_out = float(math.prod(st.out_store))
        return 2.0 * (elems_in + elems_out)  # (real, imag) pairs

    def small(st) -> bool:
        # same 2*k*m*n units and strict bound as the kernel's eligibility
        # and step_bucket's "small" — the three must agree
        return 2.0 * step_flops(st) < max_flops

    groups: list[tuple[int, int]] = []
    start: int | None = None
    run_slot = -1
    run_elems = 0.0

    def close(end: int) -> None:
        nonlocal start
        if start is not None and end - start >= 2:
            groups.append((start, end))
        start = None

    for i, st in enumerate(steps):
        cost = step_cost_elems(st)
        if start is not None:
            carried_a = st.lhs == run_slot
            carried_b = st.rhs == run_slot
            trivial = (
                (st.a_perm is None and st.a_ops is None)
                if carried_a
                else (st.b_perm is None and st.b_ops is None)
            )
            if (
                (carried_a or carried_b)
                and trivial
                and small(st)
                and run_elems + cost <= max_elems
            ):
                run_slot = st.lhs
                run_elems += cost
                continue
            close(i)
        if small(st) and cost <= max_elems:
            start = i
            run_slot = st.lhs
            run_elems = cost
        else:
            start = None
    close(len(steps))
    return tuple(groups)


def padded_elems(shape: tuple[int, ...]) -> int:
    """Tile-padded element count of an f32 buffer on the TPU: the minor
    dim pads up to 128 (XLA shrinks sublane tiles, so the second-minor
    does not pad). Copied from ``tnc_tpu.ops.budget.padded_elems``: the
    staged-prep decision below depends on it, and the port keeps that
    decision so its programs (and :func:`chain_groups`) match the
    reference step for step.

    >>> padded_elems((4, 128)), padded_elems((4, 2)), padded_elems((1024,))
    (512, 512, 1024)
    """
    if not shape:
        return 1
    n = math.prod(shape[:-1]) if len(shape) > 1 else 1
    minor = shape[-1]
    return n * (-(-minor // _MIN_MINOR) * _MIN_MINOR if minor < _MIN_MINOR else minor)


def _padded_elems(shape) -> float:
    return float(padded_elems(tuple(shape)))


def _naive_prep_bad(view, perm) -> bool:
    """True when executing ``reshape(view); transpose(perm)`` would
    materialize a buffer padded more than ``_STAGED_PAD_FACTOR``× its
    logical size (the BENCH_r02/r03 OOM mode: high-rank views with tiny
    trailing dims tile-pad 16-128×)."""
    if perm is None:
        return False
    size = math.prod(view)
    if size < _STAGED_MIN_SIZE:
        return False
    out_view = [view[p] for p in perm]
    worst = max(_padded_elems(view), _padded_elems(out_view))
    return worst > _STAGED_PAD_FACTOR * size


def _fused_transpose(src, dst, dims, tail):
    """Run-fused (view, axes) for a transpose of row legs ``src`` →
    ``dst`` above an intact fused ``tail`` dim. Legs adjacent in both
    orders collapse into one axis, keeping the materialized rank low
    (sublane padding shrinks with fewer, larger dims)."""
    pos = {l: i for i, l in enumerate(dst)}
    runs: list[list[int]] = []
    for l in src:
        if runs and pos[l] == pos[runs[-1][-1]] + 1:
            runs[-1].append(l)
        else:
            runs.append([l])
    view = tuple(int(math.prod(dims[l] for l in r)) for r in runs) + (tail,)
    order = sorted(range(len(runs)), key=lambda i: pos[runs[i][0]])
    axes = tuple(order) + (len(runs),)
    return view, axes


def _staged_ops(
    dims: list[int], perm: list[int], min_minor: int = _MIN_MINOR
) -> tuple | None:
    """Decompose an axis permutation into materialization-safe device ops.

    ``dims``: stored axis dims (leg granularity); ``perm``: target order.
    Returns a tuple of primitive ops — ``("reshape", shape)``,
    ``("transpose", axes)``, ``("lanemix", W, idx)`` — whose execution
    turns a flat buffer in ``dims`` order into ``perm`` order while every
    materialized intermediate keeps a minor dim ≥ ``min_minor`` (so XLA's
    (8, 128) tiling never lane-pads it). ``None`` ⇒ not plannable (use
    the naive reshape/transpose).

    Construction: legs that stay out of the trailing ≥128-element window
    move with cheap leading-dim transposes (the fused tail rides along
    untouched); legs crossing into or out of that window are repositioned
    by ONE static permutation of the lane window (``lanemix``) — executed
    as an exact one-hot matmul on the MXU or a gather, never as a padded
    high-rank relayout.
    """
    n = len(dims)
    total = int(math.prod(dims))
    if tuple(perm) == tuple(range(n)):
        return ()
    if total < min_minor * 2:
        return None

    # minimal target suffix with prod >= min_minor: the final fused tail
    tprod, t_i = 1, n
    while t_i > 0 and tprod < min_minor:
        t_i -= 1
        tprod *= dims[perm[t_i]]
    tset = set(perm[t_i:])
    rows_final = list(perm[:t_i])

    # minimal stored suffix with prod >= min_minor: the base lane window
    bprod, b_i = 1, n
    while b_i > 0 and bprod < min_minor:
        b_i -= 1
        bprod *= dims[b_i]
    bset = set(range(b_i, n))

    rows_stored = list(range(b_i))
    cross_in = [l for l in rows_stored if l in tset]  # must enter the tail
    cross_out = [l for l in rows_final if l in bset]  # must leave the tail
    W = int(math.prod(dims[l] for l in cross_in)) * bprod

    ops: list[tuple] = []
    nonwin_rows = [l for l in rows_final if l not in bset and l not in tset]

    # phase A: leading transpose bringing tail-bound legs next to the
    # window; the fused base tail (>=128) rides along as the minor dim
    rows_a = nonwin_rows + cross_in
    if rows_a != rows_stored:
        view, axes = _fused_transpose(rows_stored, rows_a, dims, bprod)
        ops.append(("reshape", view))
        if axes != tuple(range(len(view))):
            ops.append(("transpose", axes))

    # phase B: one static lane permutation over the window
    window_cur = cross_in + list(range(b_i, n))
    window_new = cross_out + list(perm[t_i:])
    if window_new != window_cur:

        def lane_table(cur, new):
            """Index table mapping new mixed-radix positions to old."""
            pos_cur = {l: i for i, l in enumerate(cur)}
            strides = [1] * len(cur)
            for i in range(len(cur) - 2, -1, -1):
                strides[i] = strides[i + 1] * dims[cur[i + 1]]
            new_strides = [1] * len(new)
            for i in range(len(new) - 2, -1, -1):
                new_strides[i] = new_strides[i + 1] * dims[new[i + 1]]
            width = int(math.prod(dims[l] for l in new))
            table = []
            for j in range(width):
                old = 0
                for l, s in zip(new, new_strides):
                    old += ((j // s) % dims[l]) * strides[pos_cur[l]]
                table.append(old)
            return table

        # NOTE a fixed ≥128 trailing block can't be factored out here:
        # both windows are *minimal* ≥128 suffixes, so a shared trailing
        # block that large would make them identical and phase B would
        # have been skipped (review r3) — the full-width table is the
        # only shape the permutation takes. Wide windows execute as a
        # gather (see ``_lanemix_jax``), so only the host-side table
        # size bounds W.
        if W > _LANEMIX_MAX_W:
            return None
        ops.append(("reshape", (total // W, W)))
        ops.append(("lanemix", W, tuple(lane_table(window_cur, window_new))))

    # phase C: split the window's outbound legs and finish the row order
    rows_b = nonwin_rows + cross_out
    view, axes = _fused_transpose(rows_b, rows_final, dims, tprod)
    ops.append(("reshape", view))
    if axes != tuple(range(len(view))):
        ops.append(("transpose", axes))
    return tuple(ops)


@dataclass(frozen=True)
class PairStep:
    """One pairwise contraction, fully shape-resolved.

    Executors reshape each operand's stored buffer to the run-fused
    ``*_view``, apply ``*_perm`` (identity ⇒ ``None``), contract the
    leading ``n_contract`` axes of both views against each other
    (``lax.dot_general`` on device, 2-D matmul on the host oracle), and
    store the result reshaped to ``out_store``.

    ``swap``: the dot is issued as (rhs, lhs) so the operand with the
    larger trailing free run supplies the output's minor dims.
    """

    lhs: int  # slot of left input (result replaces this slot)
    rhs: int  # slot of right input (freed after the step)
    a_view: tuple[int, ...]  # fused macro view of lhs stored buffer
    a_perm: tuple[int, ...] | None  # macro transpose (contract/free grouped)
    a_dot: tuple[int, ...]  # post-perm reshape: (k, frees…) or (frees…, k)
    a_cfirst: bool  # True: k is a_dot[0]; False: k is a_dot[-1]
    b_view: tuple[int, ...]
    b_perm: tuple[int, ...] | None
    b_dot: tuple[int, ...]
    b_cfirst: bool
    swap: bool  # issue dot as (b, a): output legs = b_free ++ a_free
    out_store: tuple[int, ...]  # storage shape of the result buffer
    # staged device prep (see `_staged_ops`): when set, device executors
    # run these ops instead of the naive reshape/transpose, keeping every
    # materialized buffer's minor dim >= 128 (no lane tile padding). The
    # host oracle still uses the equivalent (view, perm) pair.
    a_ops: tuple | None = None
    b_ops: tuple | None = None

    @property
    def a_mat(self) -> tuple[int, int]:
        """2-D (k, m) view for the host matmul oracle (orientation folded
        out by ``apply_step``)."""
        k = self.a_dot[0] if self.a_cfirst else self.a_dot[-1]
        return (k, int(math.prod(self.a_dot)) // max(k, 1))

    @property
    def b_mat(self) -> tuple[int, int]:
        k = self.b_dot[0] if self.b_cfirst else self.b_dot[-1]
        return (k, int(math.prod(self.b_dot)) // max(k, 1))


def _storage_merge(
    dims: list[int], categories: list[int] | None = None
) -> tuple[int, ...]:
    """Merge adjacent axes into a storage shape: all same-category runs
    collapse, and trailing axes keep merging (across categories if
    necessary) until the minor dim reaches ``_MIN_MINOR``.

    ``categories[i]`` groups axes the *consumer* treats alike (contracted
    vs kept); merging inside a category keeps the consumer's reshape a
    pure regroup.  ``None`` ⇒ merge everything.
    """
    if not dims:
        return ()
    if categories is None:
        categories = [0] * len(dims)
    merged: list[int] = [dims[0]]
    mcat: list[int] = [categories[0]]
    for d, c in zip(dims[1:], categories[1:]):
        if c == mcat[-1]:
            merged[-1] *= d
        else:
            merged.append(d)
            mcat.append(c)
    # trailing merge to reach a well-tiled minor dim (cross-category only
    # when a large buffer would otherwise pad)
    while len(merged) > 1 and merged[-1] < _MIN_MINOR:
        tail = merged.pop()
        merged[-1] *= tail
        mcat.pop()
    return tuple(merged)


def _fused_view(
    edges: list[tuple[int, int]], key: dict[int, tuple]
) -> tuple:
    """Run-fuse one operand for a contraction.

    ``edges``: stored (leg, dim) list.  ``key``: leg → desired sort key;
    contracted legs carry key[0] == 0, free legs key[0] == 1.

    Each operand fuses at its **own** run granularity — the two operands'
    contract parts need not match axis-for-axis, because the executor
    merges every post-perm contract axis into one ``k`` dim (an
    edge-axes reshape, layout-free on TPU) before the dot. The operand's
    **orientation** — contract runs leading ``(k, frees…)`` or trailing
    ``(frees…, k)`` — is chosen per operand: identity permutations win
    outright, otherwise the orientation whose materialized minor dim is
    larger (a ``(k, tiny-frees)`` operand would pad its tiny minor up to
    128 lanes; flipping it to ``(tiny-frees, k)`` stores perfectly).

    Returns: fused view shape, macro perm (or None), dot shape,
    contract_first flag, and the post-perm free (leg-group, dim) list.
    """
    runs: list[list[tuple[int, int]]] = []
    order = {
        leg: i
        for i, (leg, _) in enumerate(sorted(edges, key=lambda e: key[e[0]]))
    }
    for leg, dim in edges:
        if (
            runs
            and order[leg] == order[runs[-1][-1][0]] + 1
            and key[leg][0] == key[runs[-1][-1][0]][0]
        ):
            runs[-1].append((leg, dim))
        else:
            runs.append([(leg, dim)])

    view = tuple(int(math.prod(d for _, d in run)) for run in runs)

    def orientation(contract_first: bool):
        def run_key(i):
            leg_key = key[runs[i][0][0]]
            group = leg_key[0] if contract_first else (1 - leg_key[0])
            return (group, leg_key[1])

        perm_order = sorted(range(len(runs)), key=run_key)
        # Tail guard: the trailing run becomes the materialized minor
        # dim; if it is small and FREE, move the largest free run there
        # (the relayout is paid anyway — keep it well-tiled). Contract
        # runs must never reorder: their merged k-order is the pairing
        # contract with the other operand.
        if (
            perm_order
            and view[perm_order[-1]] < _MIN_MINOR
            and key[runs[perm_order[-1]][0][0]][0] != 0
        ):
            free_idx = [
                i for i in perm_order if key[runs[i][0][0]][0] != 0
            ]
            biggest = max(free_idx, key=lambda i: view[i])
            if biggest != perm_order[-1] and view[biggest] > view[perm_order[-1]]:
                perm_order.remove(biggest)
                perm_order.append(biggest)
        perm: tuple[int, ...] | None = tuple(perm_order)
        if perm == tuple(range(len(runs))):
            perm = None
        minor = view[perm_order[-1]] if perm_order else 1
        return perm_order, perm, minor

    cf = orientation(True)
    cl = orientation(False)
    if cf[1] is None:
        perm_order, perm, contract_first = cf[0], cf[1], True
    elif cl[1] is None:
        perm_order, perm, contract_first = cl[0], cl[1], False
    elif cf[2] >= cl[2]:
        perm_order, perm, contract_first = cf[0], cf[1], True
    else:
        perm_order, perm, contract_first = cl[0], cl[1], False

    k = 1
    free = []
    free_dims = []
    for i in perm_order:
        if key[runs[i][0][0]][0] == 0:
            k *= view[i]
        else:
            free.append(([leg for leg, _ in runs[i]], view[i]))
            free_dims.append(view[i])
    if contract_first:
        dot_shape = (k,) + tuple(free_dims)
    else:
        dot_shape = tuple(free_dims) + (k,)
    return view, perm, dot_shape, contract_first, free


def _staged_pack(edges, contract_order, shared):
    """Leg-granularity replacement pack for an operand whose naive prep
    would tile-pad catastrophically. Target flat order: the agreed
    k-order, then free legs in stored order. Returns
    ``(view, perm, dot, cfirst, free, ops)`` — the (view, perm) pair is
    the host oracle's equivalent naive prep — or ``None`` when the
    permutation isn't stageable (fall back to naive)."""
    stored = [leg for leg, _ in edges]
    dims = [d for _, d in edges]
    spos = {l: i for i, l in enumerate(stored)}
    free_legs = [l for l in stored if l not in shared]
    k = int(math.prod(dims[spos[l]] for l in contract_order))
    f = int(math.prod(dims[spos[l]] for l in free_legs))
    # orientation by materialized minor: a (k, tiny-f) operand would
    # lane-pad every add/dot buffer 32x (catastrophic under vmap, where
    # XLA can't always fuse it away) — put the bigger side trailing
    cfirst = f >= _MIN_MINOR or f >= k
    if cfirst:
        target = list(contract_order) + free_legs
        dot = (k, max(f, 1))
    else:
        target = free_legs + list(contract_order)
        dot = (max(f, 1), k)
    perm = [spos[l] for l in target]
    ops = _staged_ops(dims, perm)
    if ops is None:
        return None
    free = [(free_legs, f)] if free_legs else []
    return (tuple(dims), tuple(perm), dot, cfirst, free, ops)


_INF_DEATH = 1 << 60


def _pair_step(
    lhs: int,
    rhs: int,
    ta: LeafTensor,
    tb: LeafTensor,
    death: dict[int, int] | None = None,
) -> tuple[PairStep, LeafTensor]:
    """Build one contraction step.

    ``ta``/``tb`` carry each operand's legs in **stored buffer order**.
    Free legs keep that order (see `_fused_view`); ``death`` (leg → index
    of the future step that contracts it) is used to stop storage merges
    at the immediate consumer's contract/keep boundary, so the consumer's
    reshape stays a layout-free regroup.
    """
    a_edges = list(ta.edges())
    b_edges = list(tb.edges())
    a_set = {leg for leg, _ in a_edges}
    b_set = {leg for leg, _ in b_edges}
    shared = a_set & b_set
    if death is None:
        death = {}

    def build(contract_order):
        """Candidate step for one agreed k-order. Cost models the data
        movement: each operand that needs a transpose pays its size
        times the tile-padding penalty of the materialized output."""
        cpos = {leg: i for i, leg in enumerate(contract_order)}

        def keys(edges):
            key: dict[int, tuple] = {}
            for pos, (leg, _) in enumerate(edges):
                if leg in shared:
                    key[leg] = (0, cpos[leg])
                else:
                    # frees keep stored order: no merge-shuffle ever
                    # builds up, and the contract extraction is a
                    # leading-dim row gather over the intact tail
                    key[leg] = (1, pos)
            return key

        a = _fused_view(a_edges, keys(a_edges))
        b = _fused_view(b_edges, keys(b_edges))
        cost = 0.0
        for view, perm, _, _, _ in (a, b):
            if perm is None:
                continue
            size = float(math.prod(view)) if view else 1.0
            minor = view[perm[-1]] if perm else 1
            penalty = (_MIN_MINOR / minor) if minor < _MIN_MINOR else 1.0
            cost += size * penalty
        return a, b, cost

    # the agreed k-order makes one operand's contract part contiguous in
    # its own storage while the other pays a relayout — try both and
    # keep the cheaper (big x big joins would otherwise shuffle the
    # wrong side; see step-cost model in `build`)
    order_a = [leg for leg, _ in a_edges if leg in shared]
    order_b = [leg for leg, _ in b_edges if leg in shared]
    cand_a = build(order_a)
    if order_a == order_b:
        best, korder = cand_a, order_a
    else:
        cand_b = build(order_b)
        best, korder = (
            (cand_a, order_a) if cand_a[2] <= cand_b[2] else (cand_b, order_b)
        )
    (a_view, a_perm, a_dot, a_cfirst, a_free) = best[0]
    (b_view, b_perm, b_dot, b_cfirst, b_free) = best[1]
    # operands whose naive prep would tile-pad catastrophically switch to
    # the staged plan (leg granularity, minor >= 128 at every step)
    a_ops = b_ops = None
    if _naive_prep_bad(a_view, a_perm):
        staged = _staged_pack(a_edges, korder, shared)
        if staged is not None:
            (a_view, a_perm, a_dot, a_cfirst, a_free, a_ops) = staged
    if _naive_prep_bad(b_view, b_perm):
        staged = _staged_pack(b_edges, korder, shared)
        if staged is not None:
            (b_view, b_perm, b_dot, b_cfirst, b_free, b_ops) = staged
    a_k = a_dot[0] if a_cfirst else a_dot[-1]
    b_k = b_dot[0] if b_cfirst else b_dot[-1]
    assert a_k == b_k, "contract dims must agree"

    # orientation: the dot-rhs supplies the output's trailing dims — pick
    # the operand with the larger trailing free run so the stored result
    # keeps a well-tiled minor dim.
    a_tail = a_free[-1][1] if a_free else 1
    b_tail = b_free[-1][1] if b_free else 1
    swap = a_tail > b_tail

    first, second = (b_free, a_free) if swap else (a_free, b_free)
    out_legs = [leg for legs, _ in first for leg in legs] + [
        leg for legs, _ in second for leg in legs
    ]
    dim_of = {leg: d for leg, d in a_edges}
    dim_of.update({leg: d for leg, d in b_edges})
    out_dims = [dim_of[leg] for leg in out_legs]

    # storage merge boundary: the immediate consumer's contract set = the
    # earliest-dying cohort among the output legs. Categorize at LEG
    # granularity (a fused run can mix cohorts) so merges never cross the
    # consumer's contract/keep split.
    consumer_step = min(
        (death.get(leg, _INF_DEATH) for leg in out_legs), default=_INF_DEATH
    )
    out_leg_cat = [
        0 if death.get(leg, _INF_DEATH) == consumer_step else 1
        for leg in out_legs
    ]
    out_store = _storage_merge(list(out_dims), out_leg_cat)
    if not out_store:
        out_store = (1,)

    step = PairStep(
        lhs=lhs,
        rhs=rhs,
        a_view=a_view,
        a_perm=a_perm,
        a_dot=a_dot,
        a_cfirst=a_cfirst,
        b_view=b_view,
        b_perm=b_perm,
        b_dot=b_dot,
        b_cfirst=b_cfirst,
        swap=swap,
        out_store=out_store,
        a_ops=a_ops,
        b_ops=b_ops,
    )
    return step, LeafTensor(out_legs, out_dims)


@dataclass(frozen=True)
class ContractionProgram:
    """A compiled contraction path over ``num_inputs`` flat leaf slots."""

    num_inputs: int
    steps: tuple[PairStep, ...]
    result_slot: int
    result_legs: tuple[int, ...]
    result_shape: tuple[int, ...]
    stored_result_shape: tuple[int, ...] = ()
    # reference leg order (the ``^``-fold, ``contraction.rs:70-86``);
    # public APIs permute the buffer to this order host-side
    canonical_legs: tuple[int, ...] = ()

    def __post_init__(self):
        if not self.stored_result_shape:
            object.__setattr__(
                self,
                "stored_result_shape",
                self.steps[-1].out_store if self.steps else self.result_shape,
            )
        if not self.canonical_legs:
            object.__setattr__(self, "canonical_legs", self.result_legs)

    def canonical_perm(self) -> tuple[int, ...] | None:
        """Axis permutation taking the result buffer (``result_legs``
        order) to the reference's canonical order, or None if identity."""
        if self.canonical_legs == self.result_legs:
            return None
        pos = {leg: i for i, leg in enumerate(self.result_legs)}
        return tuple(pos[leg] for leg in self.canonical_legs)

    def signature(self) -> tuple:
        """Hashable identity for jit-compilation caching. ``result_shape``
        matters: two zero-step programs with different shapes must not
        share a key."""
        return (self.num_inputs, self.steps, self.result_slot, self.result_shape)


def build_program(tn: CompositeTensor, contract_path: ContractionPath) -> ContractionProgram:
    """Compile a (possibly nested) replace-left path over ``tn`` into a flat
    program. Nested children are flattened: their leaves receive global
    slots and their nested paths are inlined before the toplevel pairs,
    preserving the reference's contract-children-first order
    (``contraction.rs:42-49``).

    >>> from tnc_tpu_torch.builders.circuit_builder import Circuit
    >>> from tnc_tpu_torch.tensornetwork.tensordata import TensorData
    >>> from tnc_tpu_torch.contractionpath.paths import Greedy, OptMethod
    >>> c = Circuit(); reg = c.allocate_register(3)
    >>> c.append_gate(TensorData.gate("h"), [reg.qubit(0)])
    >>> for i in range(2):
    ...     c.append_gate(TensorData.gate("cx"), [reg.qubit(i), reg.qubit(i + 1)])
    >>> tn, _ = c.into_amplitude_network("111")
    >>> path = Greedy(OptMethod.GREEDY).find_path(tn).replace_path()
    >>> program = build_program(tn, path)
    >>> program.num_inputs, len(program.steps), program.result_shape
    (9, 8, ())
    """
    flat_slots: list[LeafTensor] = []
    # (lhs_slot, rhs_slot, lhs_legs, rhs_legs) per step, for the
    # consumer-alignment pass (leg sets are layout-independent).
    step_plan: list[tuple[int, int, frozenset[int], frozenset[int]]] = []

    def compile_composite(
        tensors: list[Tensor], cpath: ContractionPath
    ) -> tuple[int, LeafTensor]:
        """Returns the global slot holding this subnetwork's result and the
        result's metadata (leg-set level; buffer order is resolved in the
        second pass)."""
        slot_of: list[int] = []
        current: list[LeafTensor | None] = []
        for child in tensors:
            if isinstance(child, CompositeTensor):
                slot_of.append(-1)  # filled by nested compilation below
                current.append(None)
            else:
                slot = len(flat_slots)
                flat_slots.append(child)
                slot_of.append(slot)
                current.append(child)

        for i in sorted(cpath.nested):
            nested_path = cpath.nested[i]
            child = tensors[i]
            if not isinstance(child, CompositeTensor):
                raise TypeError(f"nested path at index {i} targets a leaf")
            slot, child_result = compile_composite(child.tensors, nested_path)
            slot_of[i] = slot
            current[i] = child_result

        for idx, child in enumerate(tensors):
            if isinstance(child, CompositeTensor) and slot_of[idx] == -1:
                raise ValueError(
                    f"composite child {idx} has no nested contraction path"
                )

        for i, j in cpath.toplevel:
            ta, tb = current[i], current[j]
            if ta is None or tb is None:
                raise ValueError(f"path step ({i}, {j}) uses a consumed tensor")
            step_plan.append(
                (
                    slot_of[i],
                    slot_of[j],
                    frozenset(ta.legs),
                    frozenset(tb.legs),
                )
            )
            # metadata only — the real PairSteps are built in the
            # consumer-aligned pass below (leg order there is free)
            current[i] = ta ^ tb
            current[j] = None

        survivors = [idx for idx, t in enumerate(current) if t is not None]
        if len(survivors) != 1:
            raise ValueError(
                f"path does not fully contract: {len(survivors)} tensors remain"
            )
        survivor = survivors[0]
        result = current[survivor]
        assert result is not None
        return slot_of[survivor], result

    result_slot, final = compile_composite(list(tn.tensors), contract_path)

    # Death-schedule pass: a leg of a tree-shaped path is contracted at
    # exactly one step. _pair_step uses the death times to stop storage
    # merges at each buffer's immediate consumer's contract/keep boundary
    # (see _pair_step docstring).
    death: dict[int, int] = {}
    for t, (_, _, t_la, t_lb) in enumerate(step_plan):
        for leg in t_la & t_lb:
            death[leg] = t

    steps: list[PairStep] = []
    meta: dict[int, LeafTensor] = {
        slot: leaf for slot, leaf in enumerate(flat_slots)
    }
    canonical = final  # pass-1 ^-fold order (reference semantics)
    for lhs_slot, rhs_slot, _, _ in step_plan:
        step, result = _pair_step(
            lhs_slot, rhs_slot, meta[lhs_slot], meta[rhs_slot], death
        )
        steps.append(step)
        meta[lhs_slot] = result
    final = meta[result_slot] if step_plan else final

    return ContractionProgram(
        num_inputs=len(flat_slots),
        steps=tuple(steps),
        result_slot=result_slot,
        result_legs=tuple(final.legs),
        result_shape=tuple(final.bond_dims),
        canonical_legs=tuple(canonical.legs),
    )


def flat_leaf_tensors(tn: CompositeTensor) -> list[LeafTensor]:
    """Leaves of ``tn`` in the same order `build_program` assigns slots."""
    out: list[LeafTensor] = []

    def visit(tensors: list[Tensor]) -> None:
        for child in tensors:
            if not isinstance(child, CompositeTensor):
                out.append(child)
        for child in tensors:
            if isinstance(child, CompositeTensor):
                visit(child.tensors)

    visit(list(tn.tensors))
    return out
