#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tnc_tpu_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It needs one CUDA device and ``nvcc`` (``CUDA_HOME`` or ``/usr/local/cuda``).
Phases, each of which raises on failure (nothing is caught):

1. the card's name and power limit; build the three hand kernels from
   ``tnc_tpu_torch/ops/csrc`` (one ``nvcc`` per source, in parallel) and
   print each kernel's registers and spills from ``ptxas -v``;
2. plan the main path's configuration — a 28-qubit, depth-12 random
   circuit on the Sycamore layout (p1 = p2 = 0.4, seed 42), contracted to
   its open statevector with the ``Greedy`` path — and hold each kernel
   against its plain PyTorch version on the card at the program's own
   shapes: every chain group through ``fused_chain``; every distinct
   shape the forced ``fused`` rung launches (and a ragged shape) through
   ``fused_complex_dot``, the stem's result also against a float64
   product beside cuBLAS's; one float64 case each; time kernel, plain
   version and library call (device and wall time per call, from CUDA
   events) beside the bound, ``fused_complex_dot``'s record weighted by
   the rung's launches;
3. the main path: ``contract_tensor_network(tn, path, TorchBackend())``
   once to warm up and three times timed, launch counts reset just before
   each timed run and read just after it;
4. correctness: statevector norm, four amplitudes against complex128
   amplitude networks contracted natively on the card, and the whole
   20-qubit statevector against the complex128 numpy oracle;
5. the forced ``fused`` rung (``TNC_TPU_COMPLEX_MULT=fused``) of the same
   contraction, which must launch ``fused_complex_dot``;
6. where the time goes: the device-resident part of the main path timed
   alone, and one run under ``torch.profiler`` (device time by kernel,
   busy share);
7. the PEPS cell — the norm of ``peps(4, 4, 2, 32, 0)`` with seeded
   random leaves at the O(1) scale 2^-4.5, ``Greedy`` path: first
   ``fused_transpose_dot`` against its plain version at each distinct
   shape of the steps its gate admits (float64 once; the heaviest, steps
   18/19, also against a float64 product beside cuBLAS's), timed beside
   the bound, the plain version and ``torch.einsum`` and weighted by the
   steps that have each shape; then the norm under the
   default policy (one warm-up, three timed runs, the device-resident part
   and a profile), under the forced ``fused_transpose`` rung (its launches
   and routed steps must equal the plan's gate), both against the norm in
   complex128 on the card; and ``peps(3, 3, 2, 16, 0)`` on the forced
   rung against the complex128 numpy oracle;
8. one JSON line of path numbers (with each kernel's per-shape rows and
   float64 errors), one of per-kernel numbers, the card line, and the
   last line ``{"ok": true, "device": {...}}``.

It exits non-zero without a result when CUDA is unavailable or the
``tnc_tpu_torch`` package is not beside it.
"""

from __future__ import annotations

import collections
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

QUBITS = 28
DEPTH = 12
SEED = 42
SMALL_QUBITS = 20  # the configuration checked whole against the host oracle
# the PEPS cell: peps(length, depth, physical_dim, virtual_dim, layers), its
# norm contracted exactly; and a small one checked against the host oracle
PEPS = (4, 4, 2, 32, 0)
PEPS_SMALL = (3, 3, 2, 16, 0)

# published H100 SXM peaks (dense, no sparsity) the bounds are taken from
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}  # CUDA-core FMA rates
# real flops per complex multiply-add in a bound: the Gauss identity needs
# three real products (6 flops), the least any lowering of the product
# needs, and what the single-product hand kernels do
COMPLEX_MAC_FLOPS = 6.0

F32_REL_TOL = 1e-5
F64_REL_TOL = 1e-12
# cycles of torch.cuda._sleep per second, at or above the H100's top SM
# clock (1980 MHz), so a sleep lasts at least its nominal time
SLEEP_CYCLES_PER_S = 2.0e9


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def time_ms(fn, reps: int = 20, warmup: int = 2) -> tuple[float, float]:
    """``(device_ms, wall_ms)`` per call of ``fn()``, both from CUDA events.

    ``wall_ms``: events around a loop of ``reps`` back-to-back calls, over
    ``reps`` — what a caller waits per call, host overhead included.
    ``device_ms``: the same loop queued behind ``torch.cuda._sleep`` (twice
    as long as the host took to issue the loop), so the card runs the calls
    back to back with no host gaps: its own time per call. (The profiler's
    ``key_averages()`` was tried for this and, late in this script, kept
    only some of the records of a kernel launched through ctypes.)"""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    issue_s = time.perf_counter() - t0
    end.synchronize()
    wall = start.elapsed_time(end) / reps
    torch.cuda._sleep(int(2 * issue_s * SLEEP_CYCLES_PER_S) + 1000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, wall


def kernel_instances(log: str) -> list[tuple[str, int, int]]:
    """``(label, registers, spill store bytes)`` of every kernel in a
    ``ptxas -v`` log, labelled by its template arguments: element type,
    the tile variant's integers (``Variant<T, GM, TM, TN, BK, stages, fold,
    unroll>``), and for the transpose kernel the offset type and
    pipeline."""
    out = []
    name, spill = "", 0
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name, spill = m.group(1), 0
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            t = re.search(r"VariantI([fd])((?:Li\d+E)+)", name)
            label = name[:40]
            if t:
                ints = ",".join(re.findall(r"Li(\d+)E", t.group(2)))
                label = f"{'float' if t.group(1) == 'f' else 'double'}<{ints}>"
                tail = re.match(r"EE([ix])Lb([01])E", name[t.end():])
                if tail:
                    label += " int32" if tail.group(1) == "i" else " int64"
                    label += " staged" if tail.group(2) == "1" else " direct"
            out.append((label, int(m.group(1)), spill))
            name = ""
    return out


def bound_ms(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(got, want) -> tuple[float, float]:
    """(max |got - want| over both parts, max |want| over both parts)."""
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    scale = max(float(w.abs().max()) for w in want)
    return err, scale


def build_config(qubits: int, bitstring: str | None = None):
    from tnc_tpu_torch.builders.connectivity import ConnectivityLayout
    from tnc_tpu_torch.builders.random_circuit import random_open_circuit

    circuit = random_open_circuit(
        qubits, DEPTH, 0.4, 0.4, np.random.default_rng(SEED),
        ConnectivityLayout.SYCAMORE,
    )
    return circuit.into_amplitude_network(bitstring or "*" * qubits)


def plan(tn):
    from tnc_tpu_torch.contractionpath.paths import Greedy, OptMethod

    return Greedy(OptMethod.GREEDY).find_path(tn).replace_path()


def random_buffers(program, slots_sizes, dtype, gen):
    import torch

    buffers = [None] * program.num_inputs
    for slot, size in slots_sizes.items():
        buffers[slot] = tuple(
            torch.randn(size, generator=gen, device="cuda", dtype=dtype)
            for _ in range(2)
        )
    return buffers


def chain_slot_sizes(steps) -> dict[int, int]:
    """Buffer sizes of the slots a chain group reads from outside."""
    head = steps[0]
    sizes = {head.lhs: math.prod(head.a_view), head.rhs: math.prod(head.b_view)}
    run = head.lhs
    for st in steps[1:]:
        if st.lhs == run:
            sizes[st.rhs] = math.prod(st.b_view)
        else:
            sizes[st.lhs] = math.prod(st.a_view)
        run = st.lhs
    return sizes


def check_chains(program, policy, gen) -> dict:
    """Every chain group of the program through ``fused_chain`` against
    ``fused_chain_reference`` on the card; returns the kernel's record."""
    import torch

    from tnc_tpu_torch.ops.cuda_complex import fused_chain, fused_chain_reference
    from tnc_tpu_torch.ops.split_complex import chain_operands

    rows = []
    worst = 0.0
    for s, e in policy.chains:
        steps = program.steps[s:e]
        buffers = random_buffers(program, chain_slot_sizes(steps), torch.float32, gen)
        first_ops, link_ops, links = chain_operands(steps, buffers)
        got = fused_chain(first_ops, link_ops, links)
        torch.cuda.synchronize()
        want = fused_chain_reference(first_ops, link_ops, links)
        err, scale = max_err(got, want)
        check(err <= F32_REL_TOL * scale,
              f"fused_chain {s}..{e}: max|err| {err} > {F32_REL_TOL} * {scale}")
        worst = max(worst, err)
        ms, wall = time_ms(lambda: fused_chain(first_ops, link_ops, links))
        plain, plain_wall = time_ms(lambda: fused_chain_reference(first_ops, link_ops, links))
        ops = list(first_ops) + [t for pair in link_ops for t in pair]
        nbytes = sum(t.numel() for t in ops) * 4 + 2 * got[0].numel() * 4
        shape = (first_ops[0].shape[1], first_ops[2].shape[1])
        flops = COMPLEX_MAC_FLOPS * first_ops[0].shape[0] * shape[0] * shape[1]
        for (cr, _), link in zip(link_ops, links):
            x = cr.shape[1]
            # a link contracts all K*F elements of the carried value with X
            flops += COMPLEX_MAC_FLOPS * shape[0] * shape[1] * x
            shape = link.out_shape(x)
        b_ms, b_by = bound_ms(nbytes, flops, "float32")
        rows.append((ms, plain, b_ms, b_by))
        print(f"  fused_chain steps {s}..{e - 1}: err {err:.3e} (scale {scale:.3e}) "
              f"device: kernel {ms:.5f} ms plain {plain:.5f} ms; wall per call: "
              f"kernel {wall:.5f} ms plain {plain_wall:.5f} ms; bound {b_ms:.3e} ms "
              f"({b_by})", flush=True)
    # one float64 case: the longest chain group
    s, e = max(policy.chains, key=lambda c: c[1] - c[0])
    steps = program.steps[s:e]
    buffers = random_buffers(program, chain_slot_sizes(steps), torch.float64, gen)
    ops64 = chain_operands(steps, buffers)
    err, scale = max_err(fused_chain(*ops64), fused_chain_reference(*ops64))
    check(err <= F64_REL_TOL * scale,
          f"fused_chain float64 {s}..{e}: max|err| {err} > {F64_REL_TOL} * {scale}")
    print(f"  fused_chain float64 steps {s}..{e - 1}: err {err:.3e} (scale {scale:.3e})",
          flush=True)
    print("  fused_chain: no single PyTorch call computes a chain of steps; "
          "library_ms is null", flush=True)
    n = len(rows)
    return {
        "max_abs_err": worst,
        "ms": sum(r[0] for r in rows) / n,
        "plain_ms": sum(r[1] for r in rows) / n,
        "bound_ms": sum(r[2] for r in rows) / n,
        "bound_by": "bytes" if sum(r[3] == "bytes" for r in rows) * 2 >= n else "operations",
        "library_ms": None,
    }


def fused_rung_shapes(program) -> collections.Counter:
    """``(K, M, N)`` of every ``fused_complex_dot`` launch the forced
    ``fused`` rung makes on ``program``, counted: the steps whose gate
    admits them (both operands contract-first, over the flop floor), in
    the kernel's operand order (``split_complex._try_fused_step``)."""
    from tnc_tpu_torch.ops.cuda_complex import eligible
    from tnc_tpu_torch.ops.program import step_dims

    shapes: collections.Counter = collections.Counter()
    for st in program.steps:
        m, k, n = step_dims(st)
        if st.swap:
            m, n = n, m
        if st.a_cfirst and st.b_cfirst and eligible(k, m, n):
            shapes[(k, m, n)] += 1
    return shapes


def against_float64(what, got, want, exact, scale) -> tuple[float, float]:
    """The kernel's and cuBLAS's (the plain version's) largest error
    against a float64 product, over max|C|; fails when the kernel's is
    more than twice cuBLAS's."""
    k_err = max_err([g.double() for g in got], exact)[0] / scale
    p_err = max_err([w.double() for w in want], exact)[0] / scale
    print(f"  {what} against float64: kernel {k_err:.3e}, plain (cuBLAS) "
          f"{p_err:.3e} of max|C|", flush=True)
    check(k_err <= 2 * p_err, f"{what}: error {k_err} against float64 is over "
          f"twice cuBLAS's {p_err}")
    return k_err, p_err


def check_dot(program, gen) -> dict:
    """Every distinct ``(K, M, N)`` the forced ``fused`` rung launches
    ``fused_complex_dot`` at, a ragged shape and a float64 case, against
    the plain version; returns the kernel's record, each time a mean over
    the rung's launches (each shape weighted by its launches; ``expect``:
    their count) and the per-shape rows (``shapes``)."""
    import torch

    from tnc_tpu_torch.ops.cuda_complex import (
        fused_complex_dot,
        fused_complex_dot_reference,
    )

    counts = fused_rung_shapes(program)
    # heaviest first, so the stem's float64 product fits beside nothing else
    shapes = [(k, m, n, counts[(k, m, n)])
              for k, m, n in sorted(counts, key=lambda s: -math.prod(s))]
    k, m, n, _ = shapes[len(shapes) // 2]
    shapes.append((k + 3, m + 17, n + 29, 0))  # ragged: not a launch of the rung

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=dtype)

    rows = []
    worst = 0.0
    f64 = None
    for k, m, n, launches in shapes:
        ar, ai, br, bi = rnd(k, m), rnd(k, m), rnd(k, n), rnd(k, n)
        got = fused_complex_dot(ar, ai, br, bi)
        torch.cuda.synchronize()
        want = fused_complex_dot_reference(ar, ai, br, bi)
        err, scale = max_err(got, want)
        check(err <= F32_REL_TOL * scale,
              f"fused_complex_dot {(k, m, n)}: max|err| {err} > {F32_REL_TOL} * {scale}")
        worst = max(worst, err)
        if f64 is None:
            # the longest K: both float32 results against a float64 product
            exact = fused_complex_dot_reference(*(t.double() for t in (ar, ai, br, bi)))
            f64 = against_float64(f"fused_complex_dot K={k} M={m} N={n}", got, want,
                                  exact, scale)
            del exact
        del got, want
        reps = 3 if 8.0 * k * m * n > 1e13 else 10 if 8.0 * k * m * n > 1e11 else 20
        ms, wall = time_ms(lambda: fused_complex_dot(ar, ai, br, bi), reps, 1)
        plain, _ = time_ms(lambda: fused_complex_dot_reference(ar, ai, br, bi), reps, 1)
        a_c, b_c = torch.complex(ar, ai), torch.complex(br, bi)
        lib, _ = time_ms(lambda: a_c.mT @ b_c, reps, 1)
        del a_c, b_c
        nbytes = 4.0 * 2 * (k * m + k * n + m * n)
        b_ms, b_by = bound_ms(nbytes, COMPLEX_MAC_FLOPS * k * m * n, "float32")
        if launches:
            rows.append({"k": k, "m": m, "n": n, "launches": launches, "ms": ms,
                         "plain_ms": plain, "library_ms": lib, "bound_ms": b_ms,
                         "bound_by": b_by})
        kind = f"x{launches}" if launches else "ragged"
        print(f"  fused_complex_dot {kind} K={k} M={m} N={n}: err {err:.3e} "
              f"(scale {scale:.3e}) device: kernel {ms:.4f} ms plain {plain:.4f} ms "
              f"complex64 matmul {lib:.4f} ms; kernel wall per call {wall:.4f} ms; "
              f"bound {b_ms:.4f} ms ({b_by}, {COMPLEX_MAC_FLOPS:g} flops per complex "
              f"multiply-add); kernel/plain {ms / plain:.3f}", flush=True)
        del ar, ai, br, bi
        torch.cuda.empty_cache()
    # one float64 case at the middle shape
    k, m, n, _ = shapes[len(shapes) // 2]
    ops = [rnd(k, m, dtype=torch.float64), rnd(k, m, dtype=torch.float64),
           rnd(k, n, dtype=torch.float64), rnd(k, n, dtype=torch.float64)]
    err, scale = max_err(fused_complex_dot(*ops), fused_complex_dot_reference(*ops))
    check(err <= F64_REL_TOL * scale,
          f"fused_complex_dot float64 {(k, m, n)}: max|err| {err} > {F64_REL_TOL} * {scale}")
    print(f"  fused_complex_dot float64 K={k} M={m} N={n}: err {err:.3e} "
          f"(scale {scale:.3e})", flush=True)
    return {"max_abs_err": worst, **launch_weighted(rows), "expect": sum(counts.values()),
            "float64_errors": f64, "shapes": rows}


def launch_weighted(rows) -> dict:
    """Times of per-shape rows as means over launches (each row weighted by
    its ``launches``); ``bound_by`` is the term that decides most of the
    launch-summed bound."""
    n = sum(r["launches"] for r in rows)

    def mean(key):
        return sum(r["launches"] * r[key] for r in rows) / n

    by_bytes = sum(r["launches"] * r["bound_ms"] for r in rows if r["bound_by"] == "bytes")
    return {
        "ms": mean("ms"), "plain_ms": mean("plain_ms"), "bound_ms": mean("bound_ms"),
        "bound_by": "bytes" if 2 * by_bytes > n * mean("bound_ms") else "operations",
        "library_ms": mean("library_ms"),
    }


def run_main_path(tn, path, backend, label: str, reps: int = 3) -> dict:
    """One warm-up and ``reps`` timed ``contract_tensor_network`` runs.
    Launch and routing counts are reset just before each timed run and
    read just after it. Returns the last result (``out``), the wall
    seconds of every timed run (``walls``), and the launch counts, routed
    steps and peak device memory of the last one."""
    import torch

    from tnc_tpu_torch.ops.cuda_complex import LAUNCHES, reset_launches
    from tnc_tpu_torch.ops.split_complex import (
        FUSED_ROUTED,
        FUSED_TRANSPOSE_ROUTED,
        reset_routed,
    )
    from tnc_tpu_torch.tensornetwork.contraction import contract_tensor_network

    contract_tensor_network(tn, path, backend)
    walls = []
    run = {"out": None}
    for _ in range(reps):
        run["out"] = None
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        reset_routed()
        t0 = time.perf_counter()
        out = contract_tensor_network(tn, path, backend)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        run = {
            "out": out, "walls": walls, "launches": dict(LAUNCHES),
            "routed": dict(FUSED_ROUTED),
            "transpose_routed": dict(FUSED_TRANSPOSE_ROUTED),
            "peak_bytes": torch.cuda.max_memory_allocated(),
        }
        del out
        print(f"[{label}] wall {walls[-1]:.4f} s, max_memory_allocated "
              f"{run['peak_bytes']} bytes, launches {run['launches']}, "
              f"routed {run['routed']}, transpose routed "
              f"{run['transpose_routed']}", flush=True)
    return run


def profile_device_path(tn, path, backend, label: str, reps: int = 3) -> dict:
    """Where the main path's time goes: the device-resident part
    (``execute_on_device``: placement and every step, no copy back) timed
    on its own, then one run under ``torch.profiler`` for device time by
    kernel and the device's busy share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tnc_tpu_torch.ops.program import build_program, flat_leaf_tensors

    program = build_program(tn, path)
    arrays = [leaf.data.into_data() for leaf in flat_leaf_tensors(tn)]
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = backend.execute_on_device(program, arrays)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        del out
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = backend.execute_on_device(program, arrays)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    del out
    # device-side rows only: an operator row (aten::mm) repeats the time
    # of the kernels it launched
    rows = [
        (ev.self_device_time_total, ev.key, ev.count)
        for ev in prof.key_averages()
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0
    ]
    rows.sort(reverse=True)
    busy_s = sum(r[0] for r in rows) / 1e6
    print(f"[profile {label}] device-resident run: {[f'{t:.4f}' for t in times]} s; "
          f"profiled run {prof_wall:.4f} s, device busy {busy_s:.4f} s "
          f"({busy_s / prof_wall:.3f} of it)", flush=True)
    for dev, key, count in rows[:14]:
        print(f"  {dev / 1e3:10.3f} ms  x{count:<5d} {key[:90]}", flush=True)
    return {"device_s": statistics.median(times), "device_runs_s": times,
            "profiled_s": prof_wall, "device_busy_s": busy_s}


def build_peps(args):
    """``peps(*args)`` with seeded random leaves at the O(1) scale
    (``unit_scale``: 2^-4.5 for the PEPS cell, where the default per-leaf
    scale would put the norm near float32's underflow)."""
    from tnc_tpu_torch.builders.peps import peps
    from tnc_tpu_torch.tensornetwork.approximate import attach_random_data, unit_scale

    tn = peps(*args)
    return attach_random_data(tn, np.random.default_rng(SEED), scale=unit_scale(tn))


def transpose_gate(program) -> tuple[int, dict]:
    """``(admitted, routed)``: how many steps of the program the fused
    transpose-dot's gate admits, and how many it routes, per reason."""
    from tnc_tpu_torch.ops.split_complex import fused_transpose_ineligible_reason

    reasons = [fused_transpose_ineligible_reason(st) for st in program.steps]
    return reasons.count(None), dict(collections.Counter(r for r in reasons if r))


def transpose_cases(program) -> list:
    """The distinct ``(first, second, step indices)`` operand layouts of the
    steps the fused transpose-dot's gate admits."""
    from tnc_tpu_torch.ops.split_complex import (
        _fused_transpose_layouts,
        fused_transpose_step_eligible,
    )

    cases: dict = {}
    for i, st in enumerate(program.steps):
        if fused_transpose_step_eligible(st):
            first, second = _fused_transpose_layouts(st)
            cases.setdefault((first.key(), second.key()), (first, second, []))[2].append(i)
    return list(cases.values())


def einsum_spec(a_lay, b_lay) -> str:
    """The ``torch.einsum`` equation of a transpose-dot on the stored views:
    contract digits paired in order, output the first operand's free digits
    then the second's (the kernel's flat ``(M, N)`` order)."""
    if [a_lay.view[a] for a in a_lay.k_axes] != [b_lay.view[b] for b in b_lay.k_axes]:
        fail(f"contract digits of {a_lay.key()} and {b_lay.key()} differ")
    letters = iter("abcdefghijklmnopqrstuvwxyz")
    a = [""] * len(a_lay.view)
    b = [""] * len(b_lay.view)
    for ax, bx in zip(a_lay.k_axes, b_lay.k_axes):
        a[ax] = b[bx] = next(letters)
    for ax in a_lay.f_axes:
        a[ax] = next(letters)
    for bx in b_lay.f_axes:
        b[bx] = next(letters)
    out = "".join(a[ax] for ax in a_lay.f_axes) + "".join(b[bx] for bx in b_lay.f_axes)
    return f"{''.join(a)},{''.join(b)}->{out}"


def check_transpose(program, gen) -> dict:
    """Every distinct admitted layout of the PEPS plan through
    ``fused_transpose_dot`` against ``fused_transpose_reference`` on the
    card, timed beside the bound, the plain version and ``torch.einsum``;
    returns the kernel's record, each time a mean over the plan's launches
    (each shape weighted by the steps that have it), and the per-shape rows
    (``shapes``)."""
    import torch

    from tnc_tpu_torch.ops.cuda_complex import (
        fused_transpose_dot,
        fused_transpose_reference,
        gather_copy_mode,
    )

    def rnd(shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda", dtype=dtype)

    rows = []
    worst = 0.0
    cases = sorted(transpose_cases(program),
                   key=lambda c: -c[0].k_size * c[0].f_size * c[1].f_size)
    f64 = None
    for first, second, steps in cases:
        k, m, n = first.k_size, first.f_size, second.f_size
        ops = (rnd(first.view), rnd(first.view), rnd(second.view), rnd(second.view))
        got = fused_transpose_dot(*ops, first, second)
        torch.cuda.synchronize()
        want = fused_transpose_reference(*ops, first, second)
        err, scale = max_err(got, want)
        check(err <= F32_REL_TOL * scale,
              f"fused_transpose_dot {first.key()} x {second.key()}: max|err| "
              f"{err} > {F32_REL_TOL} * {scale}")
        worst = max(worst, err)
        if f64 is None:
            # the heaviest (longest K) case against a float64 product
            exact = fused_transpose_reference(*(t.double() for t in ops), first, second)
            f64 = against_float64(f"fused_transpose_dot K={k} M={m} N={n}", got, want,
                                  exact, scale)
            del exact
        del got
        a_c, b_c = torch.complex(ops[0], ops[1]), torch.complex(ops[2], ops[3])
        spec = einsum_spec(first, second)
        lib_err = float((torch.einsum(spec, a_c, b_c).reshape(m, n)
                         - torch.complex(*want)).abs().max())
        check(lib_err <= F32_REL_TOL * 2 * scale,
              f"einsum {spec} disagrees with the plain version by {lib_err}")
        del want
        reps = 10 if 8.0 * k * m * n > 1e11 else 20
        ms, wall = time_ms(lambda: fused_transpose_dot(*ops, first, second), reps, 1)
        plain, _ = time_ms(lambda: fused_transpose_reference(*ops, first, second), reps, 1)
        lib, _ = time_ms(lambda: torch.einsum(spec, a_c, b_c), reps, 1)
        del a_c, b_c
        nbytes = 4.0 * 2 * (ops[0].numel() + ops[2].numel() + m * n)
        b_ms, b_by = bound_ms(nbytes, COMPLEX_MAC_FLOPS * k * m * n, "float32")
        modes = (gather_copy_mode(ops[0], ops[1], first), gather_copy_mode(ops[2], ops[3], second))
        rows.append({"k": k, "m": m, "n": n, "launches": len(steps), "steps": steps,
                     "modes": modes, "ms": ms, "plain_ms": plain, "library_ms": lib,
                     "bound_ms": b_ms, "bound_by": b_by})
        print(f"  fused_transpose_dot steps {steps} {first.view} k{first.k_axes} x "
              f"{second.view} k{second.k_axes} (K={k} M={m} N={n}, copy modes "
              f"{modes}): err {err:.3e} (scale {scale:.3e}) device: kernel {ms:.4f} "
              f"ms plain {plain:.4f} ms einsum {lib:.4f} ms; kernel wall per call "
              f"{wall:.4f} ms; bound {b_ms:.4f} ms ({b_by}, {COMPLEX_MAC_FLOPS:g} flops "
              f"per complex multiply-add); kernel/plain {ms / plain:.3f}", flush=True)
        del ops
        torch.cuda.empty_cache()
    # one float64 case at the smallest admitted shape
    first, second, _ = cases[-1]
    ops = [rnd(first.view, torch.float64), rnd(first.view, torch.float64),
           rnd(second.view, torch.float64), rnd(second.view, torch.float64)]
    err, scale = max_err(fused_transpose_dot(*ops, first, second),
                         fused_transpose_reference(*ops, first, second))
    check(err <= F64_REL_TOL * scale,
          f"fused_transpose_dot float64 {first.key()}: max|err| {err} > {F64_REL_TOL} * {scale}")
    print(f"  fused_transpose_dot float64 {first.view} x {second.view}: err {err:.3e} "
          f"(scale {scale:.3e})", flush=True)
    return {"max_abs_err": worst, **launch_weighted(rows), "float64_errors": f64,
            "shapes": rows}


def run_peps(backend) -> dict:
    """The PEPS cell: its norm under the default policy (timed, profiled)
    and under the forced ``fused_transpose`` rung (launches and routed
    steps held to the plan's gate), both held to the same network
    contracted in complex128 on the card; then the small PEPS on the
    forced rung against the host oracle."""
    import torch

    from tnc_tpu_torch.ops.backends import NumpyBackend, TorchBackend
    from tnc_tpu_torch.ops.program import build_program, step_flops
    from tnc_tpu_torch.ops.split_complex import plan_kernels
    from tnc_tpu_torch.tensornetwork.contraction import contract_tensor_network

    def scalar(leaf) -> complex:
        z = complex(np.asarray(leaf.data.into_data()).reshape(()))
        check(math.isfinite(z.real) and math.isfinite(z.imag), f"non-finite norm {z}")
        return z

    def forced(tn, path, label):
        os.environ["TNC_TPU_COMPLEX_MULT"] = "fused_transpose"
        try:
            return run_main_path(tn, path, backend, label, reps=1)
        finally:
            del os.environ["TNC_TPU_COMPLEX_MULT"]

    tn = build_peps(PEPS)
    path = plan(tn)
    program = build_program(tn, path)
    admitted, routed = transpose_gate(program)
    modes = plan_kernels(program).modes
    flops = [step_flops(st) for st in program.steps]
    stems = [i for i, mode in enumerate(modes) if mode == "strassen"]
    stem_flops = sum(flops[i] for i in stems)
    print(f"[peps] peps{PEPS}: {len(program.steps)} steps, {sum(flops):.4e} complex "
          f"multiply-adds, default modes {dict(collections.Counter(modes))}, Strassen "
          f"steps {stems} carry {stem_flops:.4e} ({stem_flops / sum(flops):.3f}); "
          f"fused_transpose gate admits {admitted}, routes {routed}", flush=True)

    default = run_main_path(tn, path, backend, "peps default", reps=3)
    z = scalar(default.pop("out"))
    prof = profile_device_path(tn, path, backend, "peps", reps=2)
    ft = forced(tn, path, "peps fused_transpose rung")
    z_ft = scalar(ft.pop("out"))
    check(ft["launches"]["fused_transpose_dot"] == admitted,
          f"fused_transpose_dot launched {ft['launches']['fused_transpose_dot']} "
          f"times for {admitted} admitted steps")
    check(ft["transpose_routed"] == routed,
          f"routed {ft['transpose_routed']}, the plan's gate says {routed}")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    z128 = scalar(contract_tensor_network(
        tn, path, TorchBackend(dtype="complex128", split_complex=False)))
    t128 = time.perf_counter() - t0
    for name, got in (("default rung", z), ("fused_transpose rung", z_ft)):
        rel = abs(got - z128) / abs(z128)
        print(f"[check] peps{PEPS} {name} {got!r} vs complex128 on the card "
              f"{z128!r}: relative {rel:.3e}", flush=True)
        check(rel <= 1e-4, f"peps {name} off complex128 by {rel}")
    print(f"[peps] complex128 native contraction {t128:.4f} s wall", flush=True)
    del tn

    small = build_peps(PEPS_SMALL)
    small_path = plan(small)
    run = forced(small, small_path, "peps small fused_transpose rung")
    got = scalar(run["out"])
    want = scalar(contract_tensor_network(small, small_path, NumpyBackend()))
    rel = abs(got - want) / abs(want)
    print(f"[check] peps{PEPS_SMALL} fused_transpose rung {got!r} vs numpy complex128 "
          f"{want!r}: relative {rel:.3e}", flush=True)
    check(rel <= 1e-4, f"peps{PEPS_SMALL} off the host oracle by {rel}")
    check(run["launches"]["fused_transpose_dot"] == 2,
          f"peps{PEPS_SMALL} launched fused_transpose_dot "
          f"{run['launches']['fused_transpose_dot']} times, not 2")
    return {
        "config": list(PEPS), "seed": SEED, "steps": len(program.steps),
        "admitted": admitted, "wall_s": statistics.median(default["walls"]),
        "wall_runs_s": default["walls"], "peak_bytes": default["peak_bytes"],
        **prof, "fused_transpose_wall_s": ft["walls"][0],
        "fused_transpose_peak_bytes": ft["peak_bytes"],
        "fused_transpose_launches": ft["launches"]["fused_transpose_dot"],
        "norm": [z.real, z.imag], "norm_fused_transpose": [z_ft.real, z_ft.imag],
        "norm_complex128": [z128.real, z128.imag], "complex128_wall_s": t128,
    }


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        from tnc_tpu_torch.ops import cuda_complex
    except ImportError as e:
        print(f"chip_smoke: the tnc_tpu_torch package is missing: {e}",
              file=sys.stderr)
        return 2
    from tnc_tpu_torch.ops.backends import NumpyBackend, TorchBackend
    from tnc_tpu_torch.ops.program import build_program
    from tnc_tpu_torch.ops.split_complex import plan_kernels
    from tnc_tpu_torch.tensornetwork.contraction import contract_tensor_network

    card = card_line()
    print(f"[card] {card}", flush=True)
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    # 1. build
    t0 = time.perf_counter()
    cuda_complex.build_kernels()
    print(f"[build] {len(cuda_complex.BUILD_LOG)} kernels in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for name, log in cuda_complex.BUILD_LOG.items():
        for label, regs, spill in kernel_instances(log):
            print(f"  {name} {label}: {regs} registers, {spill} bytes spill stores",
                  flush=True)

    backend = TorchBackend()  # turns TF32 off
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmul left on")

    # 2. plan + kernels against their plain versions
    tn, permutor = build_config(QUBITS)
    path = plan(tn)
    program = build_program(tn, path)
    policy = plan_kernels(program)
    admitted, routed = transpose_gate(program)
    print(f"[plan] {QUBITS} qubits: {len(program.steps)} steps, "
          f"{len(policy.chains)} chains {list(policy.chains)}; fused_transpose gate "
          f"admits {admitted}, routes {routed}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    print("[kernels] fused_chain against fused_chain_reference", flush=True)
    chain_rec = check_chains(program, policy, gen)
    print("[kernels] fused_complex_dot against fused_complex_dot_reference", flush=True)
    dot_rec = check_dot(program, gen)
    torch.cuda.empty_cache()

    # 3. main path
    main = run_main_path(tn, path, backend, "main path")
    sv_leaf, walls, launches = main["out"], main["walls"], main["launches"]
    del main
    check(launches["fused_chain"] == len(policy.chains),
          f"fused_chain launched {launches['fused_chain']} times for "
          f"{len(policy.chains)} chains")
    check(launches["fused_chain"] > 0, "main path launched no fused_chain")
    chain_rec["launches"] = launches["fused_chain"]

    # 4. correctness
    sv = np.asarray(sv_leaf.data.into_data())
    check(sv.shape == (2,) * QUBITS and np.all(np.isfinite(sv)),
          f"statevector has shape {sv.shape} or non-finite values")
    norm = float(np.vdot(sv.reshape(-1), sv.reshape(-1)).real)
    print(f"[check] statevector norm {norm:.8f}", flush=True)
    check(abs(norm - 1.0) <= 1e-4, f"norm {norm} not within 1e-4 of 1")
    qubit_of = {leg: q for q, leg in enumerate(permutor.target_leg_order)}
    oracle = TorchBackend(dtype="complex128", split_complex=False)
    for bits in np.random.default_rng(7).integers(0, 2, size=(4, QUBITS)):
        bitstring = "".join(str(int(b)) for b in bits)
        amp_tn, _ = build_config(QUBITS, bitstring)
        ref = complex(contract_tensor_network(amp_tn, plan(amp_tn), oracle)
                      .data.into_data())
        got = complex(sv[tuple(int(bits[qubit_of[leg]]) for leg in sv_leaf.legs)])
        tol = 1e-4 * max(abs(ref), 2.0 ** -14)
        print(f"[check] amplitude {bitstring}: statevector {got:.6e} "
              f"complex128 {ref:.6e} |diff| {abs(got - ref):.3e} (tol {tol:.3e})",
              flush=True)
        check(abs(got - ref) <= tol, f"amplitude {bitstring} off by {abs(got - ref)}")
    small_tn, _ = build_config(SMALL_QUBITS)
    small_path = plan(small_tn)
    got = contract_tensor_network(small_tn, small_path, backend).data.into_data()
    want = contract_tensor_network(small_tn, small_path, NumpyBackend()).data.into_data()
    diff = float(np.max(np.abs(got - want)))
    print(f"[check] {SMALL_QUBITS}-qubit statevector vs complex128 numpy: "
          f"max|diff| {diff:.3e}", flush=True)
    check(diff <= 1e-5, f"{SMALL_QUBITS}-qubit statevector off by {diff}")
    del sv_leaf

    # 5. forced fused rung
    os.environ["TNC_TPU_COMPLEX_MULT"] = "fused"
    try:
        fused = run_main_path(tn, path, backend, "fused rung", reps=1)
    finally:
        del os.environ["TNC_TPU_COMPLEX_MULT"]
    fused_leaf, fused_walls, launches = fused["out"], fused["walls"], fused["launches"]
    del fused
    check(launches["fused_complex_dot"] > 0, "fused rung launched no fused_complex_dot")
    check(launches["fused_complex_dot"] == dot_rec["expect"],
          f"fused rung launched fused_complex_dot {launches['fused_complex_dot']} times; "
          f"its timed shapes weigh {dot_rec['expect']} launches")
    dot_rec["launches"] = launches["fused_complex_dot"]
    fused_sv = np.asarray(fused_leaf.data.into_data())
    scale = float(np.max(np.abs(sv)))
    fdiff = float(np.max(np.abs(fused_sv - sv)))
    print(f"[fused rung] max|diff| vs main path {fdiff:.3e} (scale {scale:.3e})",
          flush=True)
    check(np.allclose(fused_sv, sv, rtol=1e-4, atol=1e-4 * scale),
          "fused rung disagrees with the main path")
    del fused_leaf, fused_sv, sv

    # 6. where the main path's time goes
    prof = profile_device_path(tn, path, backend, "random28")

    # 7. the PEPS cell: the transpose kernel at the plan's shapes, then
    # the path under the default policy and the forced fused_transpose rung
    peps_tn = build_peps(PEPS)
    peps_program = build_program(peps_tn, plan(peps_tn))
    del peps_tn
    print("[kernels] fused_transpose_dot against fused_transpose_reference", flush=True)
    transpose_rec = check_transpose(peps_program, gen)
    torch.cuda.empty_cache()
    peps_rec = run_peps(backend)
    transpose_rec["launches"] = peps_rec["fused_transpose_launches"]

    kernels = [
        dict(name="fused_chain", route="cuda",
             source="tnc_tpu_torch/ops/csrc/fused_chain.cu",
             replaces="tnc_tpu/ops/pallas_complex.py:637", **chain_rec),
        dict(name="fused_complex_dot", route="cuda",
             source="tnc_tpu_torch/ops/csrc/fused_complex_dot.cu",
             replaces="tnc_tpu/ops/pallas_complex.py:113", **dot_rec),
        dict(name="fused_transpose_dot", route="cuda",
             source="tnc_tpu_torch/ops/csrc/fused_transpose_dot.cu",
             replaces="tnc_tpu/ops/pallas_complex.py:391", **transpose_rec),
    ]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({
        "main_path": {"qubits": QUBITS, "depth": DEPTH, "seed": SEED,
                      "steps": len(program.steps), "chains": len(policy.chains),
                      "wall_s": statistics.median(walls), "wall_runs_s": walls,
                      "fused_rung_wall_s": fused_walls[0], **prof},
        "peps": peps_rec,
        "shapes": {"fused_complex_dot": dot_rec["shapes"],
                   "fused_transpose_dot": transpose_rec["shapes"]},
        "float64_errors": {"fused_complex_dot": dot_rec["float64_errors"],
                           "fused_transpose_dot": transpose_rec["float64_errors"]},
    }), flush=True)
    print(json.dumps({"kernels": [{k: rec[k] for k in keys} for rec in kernels]}),
          flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
