"""Chains for the chain kernel's tests, and a torch model of the kernel.

``PATH_CHAINS`` are the stage shapes ``(K, M, N)`` of every chain the
port's paths launch (random28; the sycamore53_m10 slice loop; the chunked
sycamore20_m6 and sycamore20_m8_t17 residuals, whose last is a 2048-long
dot to a scalar); :func:`make_chain` builds random operands and links of
given stage shapes. :func:`replay_chain` is a torch model of the chain
kernel (``tnc_tpu_torch/ops/csrc/fused_chain.cu``) that runs a
:class:`~tnc_tpu_torch.ops.cuda_complex._ChainPlan`'s host tables as the
kernel runs them, on the CPU.

Each launch reads its pointers from the plan's recipes (flat operand ``j``,
or the call's one allocation) and its stage rows from the table; the
resident form gets one shared-memory array per batch row (fetched operands
copied in as ``(K, F)`` rows, carried values ping-ponging), the grid form
its carried values, K-split partials and the reduction in the allocation.
Every sum is taken in the kernel's order: thread ``s`` of the ``ks`` that
split a K range takes ``k = s, s + ks, ...``, in partial sums of ``kFold``
indices folded into a running total; the ``ks`` totals are folded by the
kernel's tree; a grid stage's ``kb`` block partials are added in split
order. The checks the kernel's launch makes on a table are made here too,
and the vector reads it is told to make are checked to be legal.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tnc_tpu_torch.ops import cuda_complex as cc

PATH_CHAINS = {
    "random28 (4,4,4)": [(4, 4, 4), (4, 4, 4)],
    "random28 (2,1,2)x4": [(2, 1, 2), (2, 1, 4)],
    "random28 (2,1,2)x8": [(2, 1, 2), (2, 1, 8)],
    "random28 (2,2,8)": [(2, 2, 8), (4, 4, 4)],
    "loop (4,4,4)": [(4, 4, 4), (4, 4, 4)],
    "loop (4,8,4)x(4,4,8)": [(4, 8, 4), (4, 4, 8)],
    "loop (4,8,4)x(4,8,8)": [(4, 8, 4), (4, 8, 8)],
    "m6 (4,2,8)": [(4, 2, 8), (4, 4, 4)],
    "m6 (8,8,2)": [(8, 8, 2), (16, 1, 1)],
    "m8_t17 (256,8,256)": [(256, 8, 256), (2048, 1, 1)],
}
#: a chain whose carried value (65536 values) exceeds one block's shared
#: memory, with a 65536-long link: the grid form, with a K split
GRID_CHAIN = [(16, 256, 256), (65536, 1, 1)]


def make_chain(stages, dtype=torch.float64, batch=None, batched="all", k_axes=None,
               transposed=False, seed=0, device="cpu"):
    """``(first_ops, link_ops, links)`` of a chain of stage shapes
    ``[(K, M, N), ...]``: each link carried-first where its ``K x M`` is
    the previous result's size, else carried-second; ``k_axes[i]`` (default
    0) is link ``i``'s contract axis. With ``batch``, the head's operands
    (``batched="head"``), the links' (``"links"``) or all of them carry a
    leading batch axis; ``transposed`` gives every operand as a transposed
    view."""
    rng = np.random.default_rng(seed)

    def rnd(k, x, lead):
        shape = ((batch,) if lead else ()) + ((x, k) if transposed else (k, x))
        t = torch.from_numpy(rng.standard_normal(shape)).to(dtype=dtype, device=device)
        return t.mT if transposed else t

    k0, m0, n0 = stages[0]
    head = batch is not None and batched in ("all", "head")
    linked = batch is not None and batched in ("all", "links")
    first = (rnd(k0, m0, head), rnd(k0, m0, head), rnd(k0, n0, head), rnd(k0, n0, head))
    carried = m0 * n0
    link_ops, links = [], []
    for i, (k, m, n) in enumerate(stages[1:]):
        k_axis = k_axes[i] if k_axes else 0
        if k * m == carried:
            f, x, carried_first = m, n, True
        elif k * n == carried:
            f, x, carried_first = n, m, False
        else:
            raise ValueError(f"stage {(k, m, n)} does not take a carried value of {carried}")
        links.append(cc.ChainLink(carried_first, (k, f) if k_axis == 0 else (f, k), k_axis))
        link_ops.append((rnd(k, x, linked), rnd(k, x, linked)))
        carried = m * n
    return first, link_ops, links

HEADER = cc._CHAIN_HEADER
FIELDS = cc._CHAIN_FIELDS
THREADS = cc.CHAIN_THREADS
FOLD = cc.CHAIN_FOLD


def _view(f):
    return dict(slot=int(f[0]), sk=int(f[1]), sf=int(f[2]), sb=int(f[3]),
                re=int(f[4]), im=int(f[5]))


def stages_of(table):
    """The header and the stage rows of one launch's table, as dicts."""
    t = [int(v) for v in table]
    form, n, rows, grid, smem, red = t[:HEADER]
    out = []
    for i in range(n):
        f = t[HEADER + i * FIELDS: HEADER + (i + 1) * FIELDS]
        out.append(dict(a=_view(f[0:6]), b=_view(f[6:12]), c=_view(f[12:18]),
                        K=f[18], M=f[19], N=f[20], slow_b=f[21], tm=f[22], ks=f[23],
                        kb=f[24], vec=f[25], part=f[26], tn=f[27]))
    return dict(form=form, n=n, rows=rows, grid=grid, smem=smem, red=red), out


def _ordered_sum(pr, pi, ks):
    """The kernel's sum over the contract axis (dim 0) of products ``pr``,
    ``pi``: ``ks`` interleaved threads, partial sums of ``FOLD`` indices,
    then the threads' totals folded by the tree."""
    kr = pr.shape[0]
    per = -(-kr // ks)
    chunks = -(-per // FOLD)
    pad = chunks * FOLD * ks - kr
    shape = pr.shape[1:]
    if pad:
        zeros = torch.zeros((pad,) + shape, dtype=pr.dtype)
        pr, pi = torch.cat([pr, zeros]), torch.cat([pi, zeros])
    # index k = (c * FOLD + j) * ks + s
    pr = pr.reshape((chunks, FOLD, ks) + shape)
    pi = pi.reshape((chunks, FOLD, ks) + shape)
    accr = torch.zeros((ks,) + shape, dtype=pr.dtype)
    acci = torch.zeros((ks,) + shape, dtype=pr.dtype)
    for c in range(chunks):
        part_r = torch.zeros((ks,) + shape, dtype=pr.dtype)
        part_i = torch.zeros((ks,) + shape, dtype=pr.dtype)
        for j in range(FOLD):
            part_r = part_r + pr[c, j]
            part_i = part_i + pi[c, j]
        accr, acci = accr + part_r, acci + part_i
    h = ks // 2
    while h:
        accr[:h] = accr[:h] + accr[h:2 * h]
        acci[:h] = acci[:h] + acci[h:2 * h]
        h //= 2
    return accr[0], acci[0]


def _product(ar, ai, br, bi, ks):
    """``(M, N)`` of ``Aᵀ B`` over the rows given, in the kernel's order."""
    pr = ar[:, :, None] * br[:, None, :] - ai[:, :, None] * bi[:, None, :]
    pi = ar[:, :, None] * bi[:, None, :] + ai[:, :, None] * br[:, None, :]
    return _ordered_sum(pr, pi, ks)


def _check_stage(hdr, st, isz):
    assert (st["tm"], st["tn"]) in ((1, 1), (2, 1), (4, 1), (8, 1), (8, 2))
    assert 1 <= st["ks"] <= THREADS and st["ks"] & (st["ks"] - 1) == 0
    assert st["ks"] == 1 or st["tm"] * st["tn"] == 1 or st["ks"] == 2
    assert st["kb"] >= 1 and (st["kb"] == 1 or (hdr["form"] == 1 and st["part"] >= 0))
    assert min(st["K"], st["M"], st["N"]) >= 1
    if hdr["form"] == 1:
        assert not st["vec"] and (st["ks"] == 1 or st["tm"] * st["tn"] == 1)
        assert all(st[v]["re"] < 0 for v in "abc")
    if st["vec"]:
        slow = st["b"] if st["slow_b"] else st["a"]
        extent = st["N"] if st["slow_b"] else st["M"]
        assert st["tm"] > 1 and extent % st["tm"] == 0 and slow["re"] >= 0
        if slow["slot"] < 0:  # a carried value read as whole rows
            assert (slow["sk"], slow["sf"]) == (extent, 1)
        vec = 16 // isz
        assert slow["re"] % vec == 0 and slow["im"] % vec == 0


def _check_shared(hdr, stages, isz):
    """Every region of a resident launch's shared memory lies inside the
    block's bytes, 16-byte aligned, and no two overlap: the carried buffers
    (each used with one size per stage), the fetched operands and the
    reduction buffer."""
    regions = set()
    for st in stages:
        for side, free in (("a", st["M"]), ("b", st["N"])):
            v = st[side]
            if v["re"] >= 0 and v["slot"] >= 0:
                regions |= {(v["re"], st["K"] * free), (v["im"], st["K"] * free)}
        c = st["c"]
        if c["re"] >= 0:
            regions |= {(c["re"], st["M"] * st["N"]), (c["im"], st["M"] * st["N"])}
    split = [st["tm"] * st["tn"] for st in stages if st["ks"] > 1]
    if split:
        regions.add((hdr["red"], 2 * THREADS * max(split)))
    # a carried buffer holds values of several sizes: keep the largest
    largest = {}
    for at, n in regions:
        largest[at] = max(largest.get(at, 0), n)
    spans = sorted(largest.items())
    for (at, n), (nxt, _) in zip(spans, spans[1:]):
        assert at + n <= nxt, (at, n, nxt)
    vec = 16 // isz
    for at, n in spans:
        assert at % vec == 0 and at + n <= hdr["smem"] // isz


def replay_chain(plan, flat):
    """``(re, im)`` of the chain on ``flat`` operands, as the kernel computes
    it from ``plan``'s tables."""
    dtype = flat[0].dtype
    isz = flat[0].element_size()
    alloc = torch.full((math.prod(plan.alloc_shape),), float("nan"), dtype=dtype)
    bases = list(flat) + [alloc]

    def glob(rec, z, sb, rows, cols, sk, sf):
        """A (rows, cols) view of pointer ``rec`` = (base, byte offset) at
        batch row z."""
        base, off = rec
        t = bases[base]
        assert off % isz == 0
        at = t.storage_offset() + off // isz + z * sb
        return torch.as_strided(t, (rows, cols), (sk, sf), at)

    for lc in plan.launches:
        hdr, stages = stages_of(lc.table)
        assert hdr["form"] == cc._FORM_CODE[lc.form]
        assert len(lc.recipe) <= cc._CHAIN_MAX_PTRS and 1 <= hdr["n"] <= cc.CHAIN_STAGES_PER_LAUNCH
        recipe = lc.recipe
        for st in stages:
            _check_stage(hdr, st, isz)

        def pair(slot):
            return recipe[2 * slot], recipe[2 * slot + 1]

        if hdr["form"] == 0:
            assert hdr["smem"] <= cc.MAX_SMEM_BYTES and hdr["grid"] == hdr["rows"]
            _check_shared(hdr, stages, isz)
            for z in range(hdr["rows"]):
                sm = torch.full((hdr["smem"] // isz,), float("nan"), dtype=dtype)

                def smv(off, rows, cols, sk, sf):
                    return torch.as_strided(sm, (rows, cols), (sk, sf), off)

                for st in stages:  # the fetches at the start
                    for side, free in (("a", st["M"]), ("b", st["N"])):
                        v = st[side]
                        if v["slot"] >= 0 and v["re"] >= 0:
                            re, im = pair(v["slot"])
                            for dst, rec in ((v["re"], re), (v["im"], im)):
                                src = glob(rec, z, v["sb"], st["K"], free, v["sk"], v["sf"])
                                smv(dst, st["K"], free, free, 1).copy_(src)
                for st in stages:
                    ops = []
                    for side, free in (("a", st["M"]), ("b", st["N"])):
                        v = st[side]
                        if v["re"] >= 0:
                            sk, sf = (free, 1) if v["slot"] >= 0 else (v["sk"], v["sf"])
                            ops += [smv(v["re"], st["K"], free, sk, sf),
                                    smv(v["im"], st["K"], free, sk, sf)]
                        else:
                            re, im = pair(v["slot"])
                            ops += [glob(r, z, v["sb"], st["K"], free, v["sk"], v["sf"])
                                    for r in (re, im)]
                    cr, ci = _product(*ops, st["ks"])
                    c = st["c"]
                    if c["re"] >= 0:
                        smv(c["re"], st["M"], st["N"], c["sk"], c["sf"]).copy_(cr)
                        smv(c["im"], st["M"], st["N"], c["sk"], c["sf"]).copy_(ci)
                    else:
                        re, im = pair(c["slot"])
                        glob(re, z, c["sb"], st["M"], st["N"], c["sk"], c["sf"]).copy_(cr)
                        glob(im, z, c["sb"], st["M"], st["N"], c["sk"], c["sf"]).copy_(ci)
        else:
            rows = hdr["rows"]
            for st in stages:
                mn = st["M"] * st["N"]
                kc = -(-st["K"] // st["kb"])
                for z in range(rows):
                    ops = []
                    for side, free in (("a", st["M"]), ("b", st["N"])):
                        v = st[side]
                        re, im = pair(v["slot"])
                        ops += [glob(r, z, v["sb"], st["K"], free, v["sk"], v["sf"])
                                for r in (re, im)]
                    parts = []
                    for kbi in range(st["kb"]):
                        lo, hi = kbi * kc, min(st["K"], (kbi + 1) * kc)
                        if lo >= hi:
                            part = (torch.zeros(st["M"], st["N"], dtype=dtype),) * 2
                        else:
                            part = _product(*[o[lo:hi] for o in ops], st["ks"])
                        if st["kb"] > 1:  # each block's partials in scratch
                            at = (kbi * rows + z) * mn * isz
                            for (base, off), val in zip(pair(st["part"]), part):
                                glob((base, off + at), 0, 0, st["M"], st["N"], st["N"],
                                     1).copy_(val)
                        parts.append(part)
                    cr, ci = parts[0]
                    if st["kb"] > 1:  # read back, added in split order
                        cr = torch.zeros(st["M"], st["N"], dtype=dtype)
                        ci = torch.zeros(st["M"], st["N"], dtype=dtype)
                        for kbi in range(st["kb"]):
                            at = (kbi * rows + z) * mn * isz
                            pr, pi = (glob((base, off + at), 0, 0, st["M"], st["N"],
                                           st["N"], 1) for base, off in pair(st["part"]))
                            cr, ci = cr + pr, ci + pi
                    c = st["c"]
                    re, im = pair(c["slot"])
                    glob(re, z, c["sb"], st["M"], st["N"], c["sk"], c["sf"]).copy_(cr)
                    glob(im, z, c["sb"], st["M"], st["N"], c["sk"], c["sf"]).copy_(ci)
    n = math.prod(plan.out_shape)
    return alloc[:n].reshape(plan.out_shape), alloc[n:2 * n].reshape(plan.out_shape)
